#!/usr/bin/env python
"""Smoke run of flame_tpu's dense-mapping path on an NVIDIA GPU.

    python chip_smoke.py                # one card: phases 1-4 below
    python chip_smoke.py --four-cards   # only the 4-GPU ShardedFlame path
                                        # and the one-card run it matches

One card, at the bench's configuration (bench.make_params: VGA 640x480,
4096 feature slots, 12288 edges, 8192 triangles, 16 poseframes, degree
20, 40 smoothing iterations per frame, frame_batch 8, async topology):

  1. lower and compile pipeline.batch_step and post_delaunay_step at
     their first call, printing compile seconds and memory_analysis();
  2. drive Flame.update over the bench scene (a textured plane at 5 m,
     lateral motion) in three postures — device-resident frames, host
     numpy frames with frame_batch 4, resident frames with BA on — and
     check coverage >= 0.80 and median relative depth error <= 0.01
     against the ground truth;
  3. compare the smoother, the batched rasterizer and tracking with the
     same code on the CPU backend (flame_tpu.utils.device_parity, whose
     tolerances state their reasons);
  4. time the XLA smoother per iteration and the batched rasterizer per
     batch.

Earlier lines print the card's name and power limit (nvidia-smi) and the
Delaunay backend; the last line is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}. Without a GPU, or
when any phase fails, the script exits non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WIDTH, HEIGHT, N_FEATS = 640, 480, 4096
# Frames per phase-2 posture: resident, host_upload, resident_ba.
FRAMES = (40, 40, 48)
MIN_COVERAGE = 0.80
MAX_DEPTH_ERR = 0.01
# Four cards against one: the sharded map's coverage may differ by this
# much (a GSPMD reduction order can move a near-tie feature across a gate)
# and its idepth by this median relative amount where both are defined.
SHARD_COVERAGE_TOL = 0.02
SHARD_IDEPTH_TOL = 1e-3


# ---------------------------------------------------------------------------
# Helpers (unit-tested in tests/test_chip_smoke.py).
# ---------------------------------------------------------------------------


def smi_query() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, one card per
    line (a child process; it does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def parse_smi(text: str):
    """[(name, power_limit)] from smi_query() output."""
    cards = []
    for line in text.splitlines():
        if line.strip():
            name, limit = line.rsplit(",", 1)
            cards.append((name.strip(), limit.strip()))
    if not cards:
        raise ValueError(f"no card in nvidia-smi output {text!r}")
    return cards


def require_gpu(devices, count: int = 1):
    """SystemExit unless `devices` holds at least `count` GPUs."""
    if not devices or devices[0].platform != "gpu":
        kind = (f"{devices[0].platform} ({devices[0].device_kind})"
                if devices else "no device")
        raise SystemExit(f"flame_tpu: needs a GPU; JAX found {kind}")
    if len(devices) < count:
        raise SystemExit(f"flame_tpu: needs {count} GPUs; JAX found "
                         f"{len(devices)}")


def result_line(devices) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def quality(idepthmap, truth: float):
    """(coverage, median relative idepth error) of a dense map against a
    constant ground-truth inverse depth."""
    import numpy as np
    idm = np.asarray(idepthmap)
    defined = ~np.isnan(idm)
    cov = float(defined.mean())
    err = (float(np.median(np.abs(idm[defined] - truth) / truth))
           if defined.any() else float("inf"))
    return cov, err


def map_agreement(a, b):
    """(coverage difference, median relative idepth difference where both
    maps are defined) of two dense maps."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    da, db = ~np.isnan(a), ~np.isnan(b)
    both = da & db
    rel = (float(np.median(np.abs(a[both] - b[both]) / np.abs(b[both])))
           if both.any() else float("inf"))
    return abs(float(da.mean()) - float(db.mean())), rel


def mem_stats(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


class CompileOnFirstCall:
    """Swap mod.<name> for a wrapper whose first call lowers and compiles
    the jitted function with the real arguments (timed, memory_analysis
    printed) before running it."""

    def __init__(self, mod, names):
        self.mod, self.orig, self.report = mod, {}, {}
        for name in names:
            self.orig[name] = getattr(mod, name)
            setattr(mod, name, self._wrap(name, self.orig[name]))

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            if name not in self.report:
                t0 = time.perf_counter()
                compiled = fn.lower(*args, **kwargs).compile()
                dt = time.perf_counter() - t0
                self.report[name] = (dt, mem_stats(compiled))
                print(f"phase 1: {name} compiled in {dt:.2f} s; "
                      f"memory_analysis {self.report[name][1]}", flush=True)
            return fn(*args, **kwargs)
        return wrapped

    def restore(self):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def drive(fl, n_frames: int, resident: bool, width: int, height: int,
          placement=None):
    """Feed frames 0..n_frames-1 of the bench scene through Flame.update
    (every 2nd frame a poseframe) and return the dense map, read back to
    the host."""
    import jax
    import numpy as np
    import bench
    frames = [bench.render(width, height, bench.STEP_X * i)
              for i in range(n_frames)]
    if resident:
        frames = [jax.device_put(f, placement) for f in frames]
        jax.block_until_ready(frames)
    for i in range(n_frames):
        fl.update(i * 0.1, i, bench.pose(i), frames[i], i % 2 == 0)
    return np.asarray(fl.get_inverse_depth_map())


def main_path(width: int, height: int, n_feats: int, frames=FRAMES):
    """Phases 1 and 2. Returns the resident-posture Flame."""
    import bench
    from flame_tpu.core import pipeline
    from flame_tpu.core.flame import Flame

    K, Kinv = bench.intrinsics(width, height)
    postures = [
        ("resident", bench.make_params(False, n_feats), True),
        ("host_upload", bench.make_params(False, n_feats, frame_batch=4),
         False),
        ("resident_ba", bench.make_params(True, n_feats), True),
    ]
    keep = None
    for (name, params, resident), n in zip(postures, frames):
        watch = (CompileOnFirstCall(pipeline, ("batch_step",
                                               "post_delaunay_step"))
                 if keep is None else None)
        t0 = time.perf_counter()
        try:
            fl = Flame(width, height, K, Kinv, params)
            idm = drive(fl, n, resident, width, height)
        finally:
            if watch is not None:
                watch.restore()
        if watch is not None:
            missing = {"batch_step", "post_delaunay_step"} - set(watch.report)
            assert not missing, f"phase 1: never called {sorted(missing)}"
        cov, err = quality(idm, 1.0 / bench.PLANE_Z)
        line = (f"phase 2: {name} frame_batch="
                f"{params.solver.frame_batch} frames={n} coverage={cov:.4f}"
                f" median_rel_depth_err={err:.6f} "
                f"wall={time.perf_counter() - t0:.1f}s")
        if params.do_ba:
            solves = int(fl.stats.stats("ba_single_solves"))
            line += f" ba_solves={solves}"
        print(line, flush=True)
        assert cov >= MIN_COVERAGE, f"{name}: coverage {cov} < {MIN_COVERAGE}"
        assert err <= MAX_DEPTH_ERR, f"{name}: depth error {err}"
        if params.do_ba:
            assert solves >= 1, f"{name}: BA never solved"
        if keep is None:
            keep = fl
    return keep


def raster_views(fl, first_frame: int, n_views: int):
    """Inputs of the batched rasterizer as batch_step builds them: the
    current mesh projected from the graph's sync pose into the next
    n_views frames' poses."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import bench
    from flame_tpu.geometry import epipolar

    g = fl._graph
    vx = g.x * fl._graph_scale_dev
    sq, st = fl._last_sync_pose
    poses = [bench.pose(first_frame + b) for b in range(n_views)]
    qs = jnp.stack([q for q, _ in poses]).astype(jnp.float32)
    ts = jnp.stack([t for _, t in poses]).astype(jnp.float32)

    def view(q, t):
        geo = epipolar.load_relative(fl.K, fl.Kinv, (sq, st), (q, t))
        pos, idp = epipolar.project_idepth(geo, g.pos, vx)
        return pos, idp, g.vtx_mask & (idp > 0)

    pos, idp, ok = jax.vmap(view)(qs, ts)
    fl._ensure_tris()
    tri_ok = fl._tri_mask[None] & jnp.all(ok[:, fl._tris], axis=2)
    return tuple(np.asarray(a) for a in (pos, fl._tris, idp, tri_ok))


def parity(fl, dev, width: int, height: int, next_frame: int):
    """Phase 3. Returns the rasterizer inputs for phase 4."""
    import jax
    import bench
    from flame_tpu.utils import device_parity as dp

    cpu = jax.devices("cpu")[0]
    p = fl.params
    checks = {}
    t0 = time.perf_counter()
    checks["smoother"] = dp.smoother(p.rparams, fl._graph,
                                     p.solver.n_iters_per_frame, dev, cpu)
    views = raster_views(fl, next_frame, p.solver.frame_batch)
    checks["raster"] = dp.raster(*views, height, width, dev, cpu)
    q, t = bench.pose(next_frame)
    img = bench.render(width, height, bench.STEP_X * next_frame)
    checks["tracking"] = dp.tracking(
        p, fl.K, fl.Kinv, fl._stack, fl._feats, (next_frame, q, t, img),
        fl._curr_pf_slot, dev, cpu)
    for name, r in checks.items():
        print(f"phase 3: {name} gpu vs cpu {json.dumps(r)}", flush=True)
    print(f"phase 3: wall={time.perf_counter() - t0:.1f}s", flush=True)
    bad = [k for k, r in checks.items() if not r["ok"]]
    assert not bad, f"phase 3: outside tolerance: {bad}"
    return views


def stage_times(fl, views, dev, width: int, height: int, card: str,
                calls=50):
    """Phase 4: the XLA smoother's ms per iteration and the batched
    rasterizer's ms per batch: `calls` calls back to back, timed to
    block_until_ready, best of 5."""
    import jax
    from flame_tpu.utils import device_parity as dp
    from tools.timing import timeit

    def ms_per_call(fn, *args):
        def run():
            for _ in range(calls):
                out = fn(*args)
            jax.block_until_ready(out)
        return timeit(run, inner=calls) * 1e3

    p = fl.params
    n_it = p.solver.n_iters_per_frame
    graph = jax.device_put(fl._graph, dev)
    ms_call = ms_per_call(lambda g: dp._smooth(p.rparams, g, n_it), graph)
    V, D = graph.inc_edge.shape
    print(f"phase 4: XLA vertex smoother {ms_call / n_it:.5f} ms/iteration "
          f"(V={V}, D={D}, {n_it} iterations per call) on {card}",
          flush=True)
    dev_views = jax.device_put(views, dev)
    ms_batch = ms_per_call(lambda *a: dp._raster_batch(*a, height, width),
                           *dev_views)
    print(f"phase 4: XLA batched rasterizer {ms_batch:.4f} ms/batch "
          f"(B={views[0].shape[0]}, T={views[1].shape[0]}, {width}x{height})"
          f" on {card}", flush=True)


def four_cards(devs, width: int, height: int, n_feats: int, n_frames=40):
    """ShardedFlame over a 4-device mesh — the GSPMD vertex smoother, then
    the halo smoother, both with BA on (observation-sharded assembly) —
    each against a one-card Flame with the same parameters on the same
    frames."""
    import dataclasses
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import bench
    from flame_tpu.core.flame import Flame
    from flame_tpu.parallel import sharding
    from flame_tpu.parallel.orchestrator import ShardedFlame

    mesh = sharding.make_mesh(devs[:4])
    K, Kinv = bench.intrinsics(width, height)
    replicated = NamedSharding(mesh, P())
    t0 = time.perf_counter()
    ref = drive(Flame(width, height, K, Kinv, bench.make_params(True, n_feats)),
                n_frames, True, width, height, devs[0])
    cov, err = quality(ref, 1.0 / bench.PLANE_Z)
    print(f"four-cards: one-card reference (vertex, BA on) coverage="
          f"{cov:.4f} median_rel_depth_err={err:.6f} "
          f"wall={time.perf_counter() - t0:.1f}s", flush=True)
    for smoother in ("vertex", "halo"):
        params = bench.make_params(True, n_feats)
        params = params.replace(solver=dataclasses.replace(
            params.solver, smoother=smoother))
        t0 = time.perf_counter()
        fl = ShardedFlame(width, height, K, Kinv, params, mesh=mesh)
        idm = drive(fl, n_frames, True, width, height, replicated)
        sh = fl._feats.idepth_mu.sharding
        n_dev = len(sh.device_set)
        cov, err = quality(idm, 1.0 / bench.PLANE_Z)
        dcov, drel = map_agreement(idm, ref)
        solves = int(fl.stats.stats("ba_sharded_solves"))
        line = (f"four-cards: {smoother} BA on coverage={cov:.4f} "
                f"median_rel_depth_err={err:.6f} vs one card: "
                f"coverage_diff={dcov:.4f} median_rel_idepth_diff="
                f"{drel:.2e} state_devices={n_dev} ba_sharded_solves={solves}"
                f" wall={time.perf_counter() - t0:.1f}s")
        print(line, flush=True)
        assert n_dev == 4 and not sh.is_fully_replicated, sh
        assert dcov <= SHARD_COVERAGE_TOL, (smoother, dcov)
        assert drel <= SHARD_IDEPTH_TOL, (smoother, drel)
        assert solves >= 1, "sharded BA never solved"
        assert np.isfinite(idm[~np.isnan(idm)]).all()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU ShardedFlame path")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    require_gpu(devs, 4 if args.four_cards else 1)
    smi = smi_query()
    for name, limit in parse_smi(smi):
        print(f"card: {name}, power limit {limit}")
    print(f"nvidia-smi: {smi.splitlines()[0]}")
    print(f"device_kind: {devs[0].device_kind} x{len(devs)}")

    from flame_tpu.mesh import delaunay
    from flame_tpu.utils import compile_cache
    print(f"compile cache: {compile_cache.enable()}")
    print(f"delaunay backend: "
          f"{'native' if delaunay.native_available() else 'scipy'}",
          flush=True)
    card = smi.splitlines()[0]

    if args.four_cards:
        four_cards(devs, WIDTH, HEIGHT, N_FEATS)
    else:
        fl = main_path(WIDTH, HEIGHT, N_FEATS, FRAMES)
        views = parity(fl, devs[0], WIDTH, HEIGHT, next_frame=FRAMES[0])
        stage_times(fl, views, devs[0], WIDTH, HEIGHT, card)
    print(result_line(devs))


if __name__ == "__main__":
    main()
