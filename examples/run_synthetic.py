#!/usr/bin/env python
"""End-to-end demo: dense inverse-depth mesh estimation on a synthetic
posed monocular sequence, with debug renders written as PPM images.

Usage:
    python examples/run_synthetic.py [--frames 20] [--out $TMPDIR/flame_out]
    python examples/run_synthetic.py --cpu       # force the CPU backend

Scene: a textured fronto-parallel plane at 5 m viewed by a camera
translating sideways (the geometry of the tests/bench); ground-truth
inverse depth is 0.2 everywhere, so the printed error is a true accuracy
measure.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def write_ppm(path, rgb):
    import numpy as np
    rgb = np.asarray(rgb, np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.tobytes())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "flame_out"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--ba", action="store_true", help="enable windowed BA")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from flame_tpu.utils import compile_cache
    compile_cache.enable()

    import numpy as np
    import jax.numpy as jnp
    from flame_tpu import Flame, Params
    from flame_tpu.params import DetectionParams, SolverParams
    from flame_tpu.geometry import se3, camera

    W, H = args.width, args.height
    FX = W / 1.6
    PLANE_Z = 5.0

    def tex(X, Y):
        s = FX / 100.0
        return (128 + 60 * np.sin(4.1 * s * X + 0.9 * s * Y)
                + 35 * np.cos(1.73 * s * X) + 18 * np.sin(2.31 * s * Y))

    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)

    def render(cam_x):
        X = (uu - W / 2) * PLANE_Z / FX + cam_x
        Y = (vv - H / 2) * PLANE_Z / FX
        return np.clip(tex(X, Y), 0, 255).astype(np.uint8)

    params = Params(
        feature_capacity=2048, edge_capacity=8192, triangle_capacity=6144,
        poseframe_capacity=8, min_height=-1e6, max_height=1e6,
        idepth_init=0.05, do_ba=args.ba,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=40), debug_quiet=True)

    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = Flame(W, H, K, camera.inv_k(K), params)

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(args.frames):
        cam_x = 0.12 * i
        pose = (se3.quat_identity(), jnp.array([cam_x, 0.0, 0.0]))
        ok = fl.update(i / 30.0, i, pose, render(cam_x), i % 2 == 0)
        print(f"frame {i:3d}: ok={ok} feats={fl._n_valid} "
              f"coverage={fl.coverage():.2f}")
    dt = time.perf_counter() - t0
    print(f"\n{args.frames} frames in {dt:.1f}s "
          f"({args.frames / dt:.1f} fps incl. compile)")

    idm = fl.get_inverse_depth_map()
    err = np.abs(idm[~np.isnan(idm)] - 1 / PLANE_Z) * PLANE_Z
    print(f"median relative depth error: {np.median(err):.4f}")

    write_ppm(os.path.join(args.out, "idepthmap.ppm"),
              fl.get_debug_image_idepthmap())
    write_ppm(os.path.join(args.out, "wireframe.ppm"),
              fl.get_debug_image_wireframe())
    write_ppm(os.path.join(args.out, "features.ppm"),
              fl.get_debug_image_features())
    write_ppm(os.path.join(args.out, "normals.ppm"),
              fl.get_debug_image_normals())
    print(f"debug renders written to {args.out}/")


if __name__ == "__main__":
    main()
