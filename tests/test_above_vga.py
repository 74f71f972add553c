"""Above-VGA datapoint for the capacity machinery.

Every other quality/perf datapoint in the repo sits at or below VGA; the
capacity machinery (degree/reach/edge caps, the PACK_XY_SCALE packed-
coordinate ceiling at 2047 px, longest-edge-first shedding) claims
generality. This runs the full pipeline at 1024x768 with a 2048-feature
budget on the CPU backend and asserts (a) dense-map quality holds, (b)
no capacity counter fired, (c) the packed-coordinate bound admits the
resolution (and still rejects one past the ceiling). bench.py measures
this resolution with BENCH_RES=1024x768 BENCH_FEATS=8192.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from flame_tpu.core.flame import Flame
from flame_tpu.core import pipeline
from flame_tpu.geometry import se3, camera
from flame_tpu.params import Params, DetectionParams, SolverParams

W, H = 1024, 768
FX = 525.0 * W / 640.0  # same field of view as the VGA bench scene
PLANE_Z = 5.0


def render(cam_x, vv, uu):
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    return np.clip(128 + 60 * np.sin(21.0 * X + 4.5 * Y)
                   + 35 * np.cos(8.7 * X) + 18 * np.sin(11.6 * Y)
                   + 10 * np.sin(4.2 * X), 0, 255).astype(np.float32)


def test_xga_pipeline_quality_and_capacities():
    n_feats = 2048
    params = Params(
        feature_capacity=n_feats, edge_capacity=3 * n_feats,
        triangle_capacity=2 * n_feats, poseframe_capacity=8,
        min_height=-1e6, max_height=1e6, idepth_init=0.05,
        # win_size 32 bounds detections to (1024/32)*(768/32) = 768 new
        # features per poseframe — the XGA analogue of the VGA bench's
        # win_size 16 grid (1200 cells), scaled so the 2048-slot budget
        # turns over the same way.
        detection=DetectionParams(win_size=32),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=20,
                            pallas_reach=3, async_topology=True,
                            frame_batch=4, join_age=8),
        debug_quiet=True)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = Flame(W, H, K, camera.inv_k(K), params)
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    for i in range(16):
        cam_x = 0.08 * i
        fl.update(i * 0.1, i, (se3.quat_identity(),
                               jnp.array([cam_x, 0.0, 0.0])),
                  render(cam_x, vv, uu), i % 2 == 0)

    idm = fl.get_inverse_depth_map()
    cov = float(np.mean(~np.isnan(idm)))
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z
    assert cov > 0.5, cov
    assert float(np.median(err)) < 0.01

    # The capacity machinery must hold at this scale without shedding:
    # capacities were sized to the Delaunay maxima for the feature
    # budget, so any fired counter is a real pathology (r3 rule: counted,
    # attributed, then defaulted away).
    s = fl.stats.snapshot()["stats"]
    for k in ("tris_truncated", "edges_truncated", "edges_band_dropped",
              "edges_rank_dropped"):
        assert s.get(k, 0) == 0, (k, s.get(k))
    # Hub vertices can shed a longest edge on clustered member sets
    # (documented overflow policy); at this grid spacing none should.
    assert s.get("edges_degree_dropped", 0) <= 2


def test_packed_coordinate_ceiling():
    """1024x768 is inside the packed-u16 coordinate range; one past the
    ceiling must fail loudly at construction (core/flame.py guard)."""
    lim = int(65536 / pipeline.PACK_XY_SCALE)
    assert W < lim and H < lim
    params = Params(feature_capacity=256, edge_capacity=1024,
                    triangle_capacity=512, poseframe_capacity=4)
    K = camera.make_k(100.0, 100.0, lim / 2, 64.0)
    with pytest.raises(ValueError, match="packed-coordinate"):
        Flame(lim, 128, K, camera.inv_k(K), params)
