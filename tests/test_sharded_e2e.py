"""End-to-end multi-device test: the FULL Flame pipeline (not just the
track+smooth step) running under an 8-device mesh via
parallel.orchestrator.ShardedFlame, with a depth-accuracy assertion
Runs on the virtual 8-device CPU platform from
conftest.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flame_tpu.geometry import se3, camera
from flame_tpu.params import Params, DetectionParams, SolverParams
from flame_tpu.parallel import sharding
from flame_tpu.parallel.orchestrator import ShardedFlame

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0


def tex(X, Y):
    return (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
            + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X))


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    return tex(X, Y).astype(np.float32)


@pytest.fixture(scope="module")
def run_sharded():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    mesh = sharding.make_mesh(jax.devices()[:8])
    params = Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16),
        debug_quiet=True)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = ShardedFlame(W, H, K, camera.inv_k(K), params, mesh=mesh)
    for i in range(14):
        cam_x = 0.15 * i
        fl.update(i * 0.1, i, (se3.quat_identity(),
                               jnp.array([cam_x, 0.0, 0.0])),
                  render(cam_x), i % 2 == 0)
    return fl


def test_state_is_sharded(run_sharded):
    fl = run_sharded
    # The persistent feature/graph state must actually live sharded over
    # the mesh axis after real updates (not silently resharded to one
    # device by some step's output sharding).
    sh = fl._feats.idepth_mu.sharding
    assert not sh.is_fully_replicated
    assert len(sh.device_set) == 8


def test_sharded_depth_accuracy(run_sharded):
    fl = run_sharded
    idm = fl.get_inverse_depth_map()
    cov = np.mean(~np.isnan(idm))
    assert cov > 0.5, cov
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z
    assert np.median(err) < 0.02, np.median(err)


def test_sharded_matches_single_device(run_sharded):
    """The sharded pipeline must produce the same depths as the
    single-device pipeline (same code, partitioned execution)."""
    from flame_tpu.core.flame import Flame
    fl1 = Flame(W, H, np.asarray(run_sharded.K),
                np.asarray(run_sharded.Kinv), run_sharded.params)
    for i in range(14):
        cam_x = 0.15 * i
        fl1.update(i * 0.1, i, (se3.quat_identity(),
                                jnp.array([cam_x, 0.0, 0.0])),
                   render(cam_x), i % 2 == 0)
    a = run_sharded.get_inverse_depth_map()
    b = fl1.get_inverse_depth_map()
    both = ~np.isnan(a) & ~np.isnan(b)
    assert both.mean() > 0.5
    # Identical math up to float reduction order in segment-sums.
    assert np.nanmedian(np.abs(a[both] - b[both])) < 1e-4


def test_sharded_mesh_outputs(run_sharded):
    mesh_out = run_sharded.get_inverse_depth_mesh()
    assert mesh_out["triangles"].shape[0] > 30
    assert np.isfinite(mesh_out["idepths"]).all()


# ---------------------------------------------------------------------------
# The halo smoother END-TO-END: the full ShardedFlame sequence with the
# halo-exchange smoother doing the in-pipeline smoothing (not just
# step-level kernels), on a 4-device mesh.
# ---------------------------------------------------------------------------


def _run_halo_mode(smoother: str):
    mesh = sharding.make_mesh(jax.devices()[:4])
    params = Params(
        feature_capacity=1024, edge_capacity=4096, triangle_capacity=2048,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            smoother=smoother),
        debug_quiet=True)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = ShardedFlame(W, H, K, camera.inv_k(K), params, mesh=mesh)
    for i in range(14):
        cam_x = 0.15 * i
        fl.update(i * 0.1, i, (se3.quat_identity(),
                               jnp.array([cam_x, 0.0, 0.0])),
                  render(cam_x), i % 2 == 0)
    return fl


@pytest.fixture(scope="module", params=["halo"])
def run_halo(request):
    return _run_halo_mode(request.param), request.param


def test_halo_e2e_accuracy(run_halo):
    fl, mode = run_halo
    idm = fl.get_inverse_depth_map()
    cov = np.mean(~np.isnan(idm))
    assert cov > 0.5, (mode, cov)
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z
    assert np.median(err) < 0.02, (mode, np.median(err))


def test_halo_e2e_matches_vertex(run_halo):
    """The halo smoother must reproduce the vertex-formulation
    pipeline: same sequence, same config apart from the smoother, dense
    maps equal up to float reduction order (RCM bandwidth stays inside
    the halo, so no edge is dropped)."""
    fl, mode = run_halo
    import dataclasses
    params_v = fl.params.replace(solver=dataclasses.replace(
        fl.params.solver, smoother="vertex"))
    from flame_tpu.core.flame import Flame
    fl_v = Flame(W, H, np.asarray(fl.K), np.asarray(fl.Kinv), params_v)
    for i in range(14):
        cam_x = 0.15 * i
        fl_v.update(i * 0.1, i, (se3.quat_identity(),
                                 jnp.array([cam_x, 0.0, 0.0])),
                    render(cam_x), i % 2 == 0)
    a = fl.get_inverse_depth_map()
    b = fl_v.get_inverse_depth_map()
    both = ~np.isnan(a) & ~np.isnan(b)
    assert both.mean() > 0.5, mode
    assert np.median(np.abs(a[both] - b[both])) < 1e-4, mode


def test_halo_e2e_state_stays_sharded(run_halo):
    fl, mode = run_halo
    sh = fl._feats.idepth_mu.sharding
    assert len(sh.device_set) == 4, mode


def test_sharded_ba_e2e():
    """ShardedFlame(do_ba=True) must reach the observation-sharded psum'd
    BA assembly through BundleAdjuster.solve: max_obs is
    deliberately NOT divisible by the mesh size (rows are padded inside
    solve_window_sharded) and aniso_weights routes sqrtW through the
    sharded path too. The solve must run, be counted, be accepted, and
    keep the (already-correct) synthetic poses near-unchanged."""
    import dataclasses
    from flame_tpu.params import BAParams

    mesh = sharding.make_mesh(jax.devices()[:8])
    params = Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16),
        do_ba=True,
        ba=BAParams(window_size=4, n_gn_iters=3, obs_capacity=4096,
                    max_landmarks=256, max_obs=1001, aniso_weights=True),
        debug_quiet=True)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = ShardedFlame(W, H, K, camera.inv_k(K), params, mesh=mesh)
    gt = []
    for i in range(14):
        cam_x = 0.15 * i
        t = np.array([cam_x, 0.0, 0.0])
        gt.append(t)
        fl.update(i * 0.1, i, (se3.quat_identity(), jnp.asarray(t)),
                  render(cam_x), i % 2 == 0)
    assert fl.stats.stats("ba_sharded_solves") >= 1
    assert fl.stats.stats("ba_single_solves") == 0.0
    assert fl._ba.last_cost is not None and np.isfinite(fl._ba.last_cost)
    assert fl._ba.last_accepted
    # Input poses are exact; an accepted solve must not corrupt them.
    for fid, slot in fl._pf_slot_by_id.items():
        t_dev = np.asarray(fl._stack.t[slot])
        assert np.linalg.norm(t_dev - gt[fid]) < 0.02, (fid, t_dev)


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Save/load under a mesh must RESTORE the
    NamedSharding placements (a plain restore silently collapsed a
    resumed ShardedFlame onto one device) and the resumed run must
    continue and match the uninterrupted one."""
    import dataclasses
    import os
    from flame_tpu.utils import checkpoint

    mesh = sharding.make_mesh(jax.devices()[:8])
    params = Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            deterministic=True),
        debug_quiet=True)
    K = camera.make_k(FX, FX, W / 2, H / 2)

    def run(fl, a, b):
        for i in range(a, b):
            cam_x = 0.15 * i
            fl.update(i * 0.1, i, (se3.quat_identity(),
                                   jnp.array([cam_x, 0.0, 0.0])),
                      render(cam_x), i % 2 == 0)

    fl = ShardedFlame(W, H, K, camera.inv_k(K), params, mesh=mesh)
    run(fl, 0, 10)
    path = os.path.join(tmp_path, "sharded.npz")
    checkpoint.save(path, fl)

    fl2 = ShardedFlame(W, H, K, camera.inv_k(K), params, mesh=mesh)
    checkpoint.load(path, fl2)

    # Placements restored: the feature/graph state must span the mesh
    # with the SAME shardings the constructor laid out, not sit on one
    # device.
    for name, arr in [("feats.mu", fl2._feats.idepth_mu),
                      ("graph.x", fl2._graph.x),
                      ("curr.xy", fl2._curr.xy)]:
        sh = arr.sharding
        assert len(sh.device_set) == 8, (name, sh)
        assert not sh.is_fully_replicated, name
    assert fl2._stack.img_pad.sharding.is_fully_replicated

    # Continue BOTH runs; they must agree (deterministic async joins).
    run(fl, 10, 16)
    run(fl2, 10, 16)
    a = fl.get_inverse_depth_map()
    b = fl2.get_inverse_depth_map()
    np.testing.assert_array_equal(a, b)
    assert np.mean(~np.isnan(b)) > 0.5
