"""Multi-device sharding tests on the virtual 8-device CPU mesh:
the edge-sharded smoother must be numerically equivalent to the
single-device solver, and the full sharded step must run."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flame_tpu.optimize import nltgv2
from flame_tpu.parallel import sharding
from flame_tpu.params import RegularizerParams

from test_nltgv2 import make_grid_graph

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def test_sharded_smooth_matches_single_device():
    p = RegularizerParams()
    g, V, E = make_grid_graph(n=6, v_cap=64, e_cap=256, degree=12,
                              noise=0.3, seed=21)
    mesh = sharding.make_mesh(jax.devices()[:8])

    g_ref = nltgv2.smooth(p, g, 25)
    g_sh = sharding.sharded_smooth(p, g, 25, mesh)

    np.testing.assert_allclose(np.asarray(g_sh.x), np.asarray(g_ref.x),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(g_sh.w1), np.asarray(g_ref.w1),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(g_sh.q1), np.asarray(g_ref.q1),
                               atol=1e-5)


def test_sharded_smooth_energy_decreases():
    p = RegularizerParams(step_x=0.01, step_q=12.5)
    g, V, E = make_grid_graph(n=6, v_cap=64, e_cap=256, degree=12,
                              noise=0.4, seed=23)
    mesh = sharding.make_mesh(jax.devices()[:8])
    e0 = float(nltgv2.energy(p, g))
    g1 = sharding.sharded_smooth(p, g, 200, mesh)
    e1 = float(nltgv2.energy(p, g1))
    assert e1 < e0


def test_dryrun_multichip_entrypoint():
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(8)


def test_dryrun_multichip_refuses_missing_devices():
    """Asked for more devices than the process has, the dry run raises
    instead of substituting virtual CPU devices for the accelerator."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from __graft_entry__ import dryrun_multichip
    with pytest.raises(RuntimeError, match="needs"):
        dryrun_multichip(len(jax.devices()) + 1)


def test_distributed_ba_matches_single_device():
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_ba import build_problem
    from flame_tpu.parallel import distributed_ba
    from flame_tpu.params import BAParams

    rng = np.random.default_rng(77)
    K, Kinv, problem, truth = build_problem(rng)
    # Pad observations to a multiple of 8 devices.
    M = problem.obs.u_ref.shape[0]
    pad = (-M) % 8
    if pad:
        obs = problem.obs
        problem = problem._replace(obs=obs._replace(
            anchor_idx=jnp.pad(obs.anchor_idx, (0, pad)),
            obs_idx=jnp.pad(obs.obs_idx, (0, pad)),
            lm_idx=jnp.pad(obs.lm_idx, (0, pad)),
            u_ref=jnp.pad(obs.u_ref, ((0, pad), (0, 0))),
            u_obs=jnp.pad(obs.u_obs, ((0, pad), (0, 0))),
            valid=jnp.pad(obs.valid, (0, pad))))

    from flame_tpu.ba import schur
    params = BAParams(n_gn_iters=5, damping=1e-6, pose_prior_weight=0.0)
    mesh = sharding.make_mesh(jax.devices()[:8])

    q1, t1, lm1, c1 = schur.solve_window(params, K, Kinv, problem, n_fixed=2)
    q2, t2, lm2, c2 = distributed_ba.solve_window_sharded(
        params, K, Kinv, problem, mesh, n_fixed=2)

    np.testing.assert_allclose(np.asarray(t2), np.asarray(t1), atol=1e-4)
    np.testing.assert_allclose(np.asarray(q2), np.asarray(q1), atol=1e-4)
    np.testing.assert_allclose(np.asarray(lm2), np.asarray(lm1), atol=1e-4)
