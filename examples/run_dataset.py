#!/usr/bin/env python
"""Run flame_tpu on a TUM RGB-D or EuRoC directory.

Usage:
    python examples/run_dataset.py --format tum --root /path/to/fr1_xyz \
        --fx 517.3 --fy 516.5 --cx 318.6 --cy 255.3 [--frames 200]
    python examples/run_dataset.py --format euroc --root /path/to/MH_01 \
        --fx 458.65 --fy 457.30 --cx 367.22 --cy 248.38

Writes colormapped idepth/wireframe renders of the final frame to --out.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--format", choices=("tum", "euroc"), required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--fx", type=float, required=True)
    ap.add_argument("--fy", type=float, required=True)
    ap.add_argument("--cx", type=float, required=True)
    ap.add_argument("--cy", type=float, required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--poseframe-every", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "flame_dataset_out"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ba", action="store_true")
    ap.add_argument("--min-height", type=float, default=-1e6)
    ap.add_argument("--max-height", type=float, default=1e6)
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from flame_tpu.utils import compile_cache
    compile_cache.enable()

    import numpy as np
    from flame_tpu import Flame, Params
    from flame_tpu.geometry import camera
    from flame_tpu.io import datasets
    from flame_tpu.params import SolverParams

    if args.format == "tum":
        frames = datasets.load_tum(args.root, max_frames=args.frames)
    else:
        frames = datasets.load_euroc(args.root, max_frames=args.frames)
    if not frames:
        print("no frames loaded", file=sys.stderr)
        return 1
    first = frames[0].load_image()
    H, W = first.shape
    print(f"loaded {len(frames)} frames at {W}x{H}")

    params = Params(min_height=args.min_height, max_height=args.max_height,
                    do_ba=args.ba,
                    solver=SolverParams(n_iters_per_frame=60,
                                        async_topology=True),
                    debug_quiet=True)
    K = camera.make_k(args.fx, args.fy, args.cx, args.cy)
    fl = Flame(W, H, K, camera.inv_k(K), params)

    out = datasets.run_sequence(fl, frames,
                                poseframe_every=args.poseframe_every,
                                progress=True)
    print(json.dumps({k: v for k, v in out.items() if k != "timings_ms"},
                     indent=2))

    os.makedirs(args.out, exist_ok=True)

    def write_ppm(path, rgb):
        rgb = np.asarray(rgb, np.uint8)
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
            f.write(rgb.tobytes())

    write_ppm(os.path.join(args.out, "idepthmap.ppm"),
              fl.get_debug_image_idepthmap())
    write_ppm(os.path.join(args.out, "wireframe.ppm"),
              fl.get_debug_image_wireframe())
    print(f"renders written to {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
