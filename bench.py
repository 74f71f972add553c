#!/usr/bin/env python
"""flame_tpu benchmark: dense mesh estimation throughput on one GPU.

Prints ONE JSON line:
  {"metric": "vga_dense_fps_per_chip", "value": N, "unit": "frames/sec",
   "vs_baseline": N / 100, "solver_iters_per_sec": M,
   "modes": {"resident": N, "host_upload": N2, "resident_ba": N3},
   "windows": {...}, "latency_ms_p50": L, "latency_ms_p95": L2,
   "win_fps_best": B, "device": {...}, ...}

The baseline is the target of 100 fps per device for VGA dense mesh
estimation (BASELINE.md: the reference publishes no numbers; its README
claims real-time CPU operation only). solver_iters_per_sec is NLTGV2-L1
primal-dual iterations/sec through the production smoother on the live
end-of-run graph. Refuses to run without a GPU (there is no CPU fallback:
a CPU number is not a device measurement).

The DEFAULT run measures the full deployment posture, one JSON artifact:
  * resident    — device-resident uint8 frames (the analogue of DMA/PCIe
                  camera ingestion; only topology words are uploaded per
                  batch). The headline number.
  * host_upload — numpy frames; image bytes + topology ride ONE
                  coalesced upload per batch.
  * resident_ba — resident ingestion with the windowed bundle adjuster
                  ON (ba/window.py async pipeline: obs ride the packed
                  fetch, solves apply 1-2 batches later).
Secondary modes run fewer windows (BENCH_WINDOWS_SECONDARY, default 12)
to bound total runtime; per-mode window counts are recorded in the
artifact. Every window ends in a host read of the dense map, so its time
covers the device work it dispatched; nothing is subtracted.

Env knobs: BENCH_MODES comma-list reorders/trims the modes (first =
headline); BENCH_RESIDENT=0 / BENCH_BA=1 promote host_upload /
resident_ba to the headline. BENCH_RES=WxH and BENCH_FEATS=N scale the
scene off the VGA x 4096 default point (capacities scale with N).
BENCH_VERBOSE=1 prints per-window/timing details to stderr.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PLANE_Z = 5.0  # the bench scene: a textured plane 5 m ahead


def render(width: int, height: int, cam_x: float):
    """The bench scene from a camera translated cam_x m sideways: a
    fronto-parallel textured plane at PLANE_Z, as a uint8 image (ground
    truth inverse depth 1/PLANE_Z everywhere)."""
    import numpy as np
    fx = 525.0 * width / 640.0  # constant field of view across sizes
    vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
    X = (uu - width / 2) * PLANE_Z / fx + cam_x
    Y = (vv - height / 2) * PLANE_Z / fx
    # World-to-pixel scale at VGA is Z/fx ~ 0.0095; frequencies chosen so
    # image gradients clear the detection threshold (>= 5/px).
    tex = (128 + 60 * np.sin(21.0 * X + 4.5 * Y) + 35 * np.cos(8.7 * X)
           + 18 * np.sin(11.6 * Y) + 10 * np.sin(4.2 * X))
    return np.clip(tex, 0, 255).astype(np.uint8)


def intrinsics(width: int, height: int):
    from flame_tpu.geometry import camera
    fx = 525.0 * width / 640.0
    K = camera.make_k(fx, fx, width / 2, height / 2)
    return K, camera.inv_k(K)


STEP_X = 0.08  # camera translation per frame, m


def pose(i: int):
    """Camera-to-world pose of frame i: pure lateral translation."""
    import jax.numpy as jnp
    from flame_tpu.geometry import se3
    return (se3.quat_identity(), jnp.array([STEP_X * i, 0.0, 0.0]))


def make_params(do_ba: bool, n_feats: int = 4096, frame_batch=None):
    from flame_tpu.params import (Params, DetectionParams, SolverParams,
                                  BAParams)
    # BA posture for the bench (resident_ba mode): the bench declares
    # every 2nd frame a poseframe (far denser than a real frontend's
    # ~1-in-10), so solving at every new poseframe would run the window
    # solve twice per 4-frame batch. Warm-started solves every 4 new
    # poseframes (2 refinements per window_size=8 turnover) with 3 GN
    # iterations (tests/test_dataset_accuracy.py's
    # test_ba_reduces_ate_on_noisy_poses pins quality with the default
    # cadence).
    ba = BAParams(n_gn_iters=int(os.environ.get("BENCH_BA_GN", 3)),
                  solve_min_new_pfs=int(
                      os.environ.get("BENCH_BA_MINPF", 4)))
    # Capacities sized to Delaunay maxima for n_feats features (T <= 2V,
    # E <= 3V): the per-frame topology upload scales with them.
    return Params(
        feature_capacity=n_feats, edge_capacity=3 * n_feats,
        triangle_capacity=2 * n_feats,
        poseframe_capacity=16,
        min_height=-1e6, max_height=1e6,
        idepth_init=0.05,
        min_baseline=float(os.environ.get('BENCH_MINB', 0.01)),
        detection=DetectionParams(win_size=16),
        do_ba=do_ba, ba=ba,
        solver=SolverParams(
            # 20 incidence slots cover the observed Delaunay degree of
            # the bench meshes with margin (the capacity-drop counters
            # attribute drops at degree 16 to per-vertex slot overflow);
            # reach=3 keeps the halo smoother's RCM band clean.
            max_vertex_degree=int(os.environ.get("BENCH_DEGREE", 20)),
            pallas_reach=int(os.environ.get("BENCH_REACH", 3)),
            async_topology=True,
            topology_lag=int(os.environ.get("BENCH_LAG", 2)),
            # Eight frames per device dispatch (pipeline.batch_step): ONE
            # upload + ONE jit per batch. Host-upload mode overrides to 4
            # (see mode_params in main): its upload is serialized image
            # bytes, so the batch size scales the blocking upload.
            frame_batch=(int(frame_batch) if frame_batch is not None
                         else int(os.environ.get("BENCH_BATCH", 8))),
            fetch_stride=int(os.environ.get("BENCH_STRIDE", 1)),
            # Age (frames) at which an unlanded packed transfer is shed
            # (see SolverParams.join_age), here 3 batches of 8.
            join_age=int(os.environ.get("BENCH_JOINAGE", 24)),
            max_consecutive_sheds=int(os.environ.get("BENCH_SHEDS", 8)),
            smoother=os.environ.get("BENCH_SMOOTHER", "auto"),
            n_iters_per_frame=int(os.environ.get("BENCH_ITERS", 40))),
        debug_quiet=True)


def measure_mode(params, frames_np, resident: bool, n_warm: int,
                 n_windows: int, win_len: int):
    """One full throughput measurement: fresh Flame, warmup, windowed
    measurement with real drains. Returns (fps_median, win_fps, fl,
    latency_pcts)."""
    import numpy as np
    import jax
    from flame_tpu.core.flame import Flame

    W, H = frames_np[0].shape[1], frames_np[0].shape[0]
    K, Kinv = intrinsics(W, H)
    fl = Flame(W, H, K, Kinv, params)

    if resident:
        frames = [jax.device_put(f) for f in frames_np]
        # Staging completes before the clock.
        jax.block_until_ready(frames)
    else:
        frames = frames_np

    for i in range(n_warm):
        fl.update(i * 0.1, i, pose(i), frames[i], i % 2 == 0)
        if i % 8 == 7:
            # Drain mid/post-warmup: compiles and first-use executable
            # loads complete HERE, not in window 1.
            np.asarray(fl._idepthmap[0, 0])

    # Latency samples restart here: warmup frames' samples include
    # compile stalls that are not steady-state latency. Fetches staged
    # DURING warmup but still in flight carry warmup entry stamps — strip
    # those too, or their landings re-inject the compile-stall samples
    # the clear is removing.
    fl._packed_queue = type(fl._packed_queue)(
        (pk, fr, meta, [None] * len(tent))
        for pk, fr, meta, tent in fl._packed_queue)
    fl._zombie_fetches = [(pk, None) for pk, _t in fl._zombie_fetches]
    fl._latency_samples.clear()

    # Measure in windows, each ending with a host read of the dense map
    # (which waits for every dispatch the window made). The median window
    # is the sustained rate.
    win_fps = []
    k = 0
    for w in range(n_windows):
        t0 = time.perf_counter()
        for j in range(win_len):
            i = n_warm + k
            fl.update(i * 0.1, i, pose(i), frames[i], i % 2 == 0)
            k += 1
        np.asarray(fl._idepthmap[0, 0])
        win_fps.append(win_len / (time.perf_counter() - t0))

    return (float(np.median(win_fps)), win_fps, fl,
            fl.latency_percentiles())


def solver_rate(params, fl):
    """NLTGV2 primal-dual iterations/sec on the live graph through the
    production smoother, timed to block_until_ready."""
    import jax
    from flame_tpu.core.pipeline import resolve_smoother
    from flame_tpu.optimize import nltgv2

    assert resolve_smoother(params) == "vertex"
    K_IT = 4000
    smooth = jax.jit(lambda g: nltgv2.smooth(params.rparams, g, K_IT,
                                             mode="vertex"))
    jax.block_until_ready(smooth(fl._graph))
    t0 = time.perf_counter()
    jax.block_until_ready(smooth(fl._graph))
    return K_IT / (time.perf_counter() - t0)


def resolve_modes():
    """Mode list, headline first. Default: the full deployment posture.
    BENCH_MODES trims/reorders explicitly; BENCH_RESIDENT=0 / BENCH_BA=1
    promote a secondary mode to the headline (back-compat knobs)."""
    env = os.environ.get("BENCH_MODES")
    if env:
        modes = [m.strip() for m in env.split(",") if m.strip()]
        bad = set(modes) - {"resident", "host_upload", "resident_ba"}
        if bad:
            raise SystemExit(f"BENCH_MODES: unknown mode(s) {sorted(bad)}")
        if not modes:
            raise SystemExit("BENCH_MODES: no modes parsed")
        return modes
    ba = os.environ.get("BENCH_BA", "0") != "0"
    host = os.environ.get("BENCH_RESIDENT", "1") == "0"
    if ba and host:
        # The mode split has no host-upload-with-BA posture, so fail
        # loudly instead of silently measuring a different one.
        raise SystemExit("BENCH_BA=1 with BENCH_RESIDENT=0 is no longer "
                         "a single posture; pick modes explicitly with "
                         "BENCH_MODES")
    modes = ["resident", "host_upload", "resident_ba"]
    if ba:
        modes.remove("resident_ba")
        modes.insert(0, "resident_ba")
    elif host:
        modes.remove("host_upload")
        modes.insert(0, "host_upload")
    return modes


def main():
    import numpy as np
    import jax

    from chip_smoke import require_gpu
    from flame_tpu.utils import compile_cache

    devs = jax.devices()
    require_gpu(devs)
    compile_cache.enable()

    # Default VGA; BENCH_RES=WxH + BENCH_FEATS scale the measurement off
    # the single VGA x 4096 point.
    res = os.environ.get("BENCH_RES", "640x480")
    W, H = (int(v) for v in res.split("x"))
    n_feats = int(os.environ.get("BENCH_FEATS", 4096))

    modes = resolve_modes()

    def mode_params(mode):
        if mode == "host_upload":
            # Smaller batches for host ingestion: the serialized
            # image-byte upload scales with the batch and delays the
            # dispatch.
            return make_params(False, n_feats,
                               frame_batch=os.environ.get(
                                   "BENCH_BATCH_HOST", 4))
        return make_params(mode == "resident_ba", n_feats)

    # Warmup must cover a FULL steady-state cycle, not just the first
    # dispatches: the first packed fetch is staged at dispatch
    # fetch_stride, consumed a few frames later, triangulated async, and
    # applied one batch after that — only then has every jit variant on
    # the steady-state path executed once. (+8 with BA on: the first
    # window solve stages ~frame 6 and its apply-side executables first
    # run 1-2 batches later; they must compile inside warmup.) Per-mode
    # win_len is rounded UP to a multiple of that mode's frame_batch so
    # every window's frames are fully dispatched before its drain.
    n_windows = int(os.environ.get("BENCH_WINDOWS", 25))
    n_windows_2nd = min(int(os.environ.get("BENCH_WINDOWS_SECONDARY", 12)),
                        n_windows)
    base_win = int(os.environ.get("BENCH_WINLEN", 16))

    def _win_len(fb):
        return -(-base_win // max(int(fb), 1)) * max(int(fb), 1)

    # Per-mode win_len is NOT monotonic in frame_batch (ceil-to-multiple
    # rounding), so size the frame pool on the max over actual win_lens.
    win_len_max = max(_win_len(mode_params(m).solver.frame_batch)
                      for m in modes)
    n_warm_max = 16 + 8  # BA warmup is the longest
    frames_np = [render(W, H, STEP_X * i)
                 for i in range(n_warm_max + n_windows * win_len_max)]

    # Image ingestion. resident = device-resident frames staged off the
    # clock (the analogue of a DMA/PCIe camera feed). host_upload
    # measures the full host-ingestion path instead (images + topology
    # coalesced, one transfer per batch). Poses are created per frame ON
    # the clock, as a frontend delivers them.
    mode_fps, mode_windows = {}, {}
    headline = None
    for mi, mode in enumerate(modes):
        do_ba = mode == "resident_ba"
        params = mode_params(mode)
        win_len = _win_len(params.solver.frame_batch)
        n_warm = 16 + (8 if do_ba else 0)
        nw = n_windows if mi == 0 else n_windows_2nd
        fps, win_fps, fl, lat = measure_mode(
            params, frames_np[: n_warm + nw * win_len],
            mode != "host_upload", n_warm, nw, win_len)
        mode_fps[mode] = round(fps, 2)
        mode_windows[mode] = nw
        if mi == 0:
            headline = (mode, fps, win_fps, fl, lat, params)

    mode, fps, win_fps, fl, lat, params = headline
    iters_per_sec = solver_rate(params, fl)

    idm = fl.get_inverse_depth_map()
    cov = float(np.mean(~np.isnan(idm)))
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z

    metric = ("vga_dense_fps_per_chip" if (W, H) == (640, 480)
              else f"{res}_dense_fps_per_chip")
    result = {
        "metric": metric,
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 100.0, 4),
        "solver_iters_per_sec": round(iters_per_sec),
        "modes": mode_fps,
        "windows": mode_windows,
        "do_ba": mode == "resident_ba",
        "coverage": round(cov, 3),
        # null (not NaN — bare NaN is not strict JSON) when the map is
        # empty: exactly the catastrophic runs a parser must not choke on.
        "median_rel_depth_err": (round(float(np.median(err)), 4)
                                 if err.size else None),
        "win_fps_best": round(float(np.max(win_fps)), 1),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
    }
    if lat is not None:
        # update()->map-host-visible latency of the headline mode
        # (Flame.latency_percentiles; samples post-warmup only). The
        # batching design trades latency for throughput (frame_batch-1
        # frames of buffering + fetch-cadence delivery) — this records
        # the actual cost, not the theoretical one.
        result["latency_ms_p50"] = round(lat[0], 1)
        result["latency_ms_p95"] = round(lat[1], 1)
    snap = fl.stats.snapshot()["stats"]
    result["packed_sheds"] = int(snap.get("packed_sheds", 0))

    if os.environ.get("BENCH_VERBOSE"):
        extra = {
            "win_fps": [round(f, 1) for f in win_fps],
            "n_feats": int(np.asarray(fl._feats.valid).sum()),
            "n_vtx": int(np.asarray(fl._graph.vtx_mask).sum()),
            "n_edges": fl._n_edges,
            "timings_ms": {k: round(v, 2) for k, v in
                           fl.stats.snapshot()["timings_ms"].items()},
            "stats": {k: round(v, 3) for k, v in snap.items()},
        }
        if mode == "resident_ba" and fl._ba is not None:
            extra["ba_last_cost"] = fl._ba.last_cost
            extra["ba_last_accepted"] = fl._ba.last_accepted
        print(json.dumps(extra), file=sys.stderr)

    print(json.dumps(result))


if __name__ == "__main__":
    main()
