"""Distributed windowed BA: observation-sharded normal-equation assembly.

The Schur assembly (flame_tpu/ba/schur.py) is segment-sums over
observations, so it distributes as classic data parallelism: each device
assembles partial (Hpp, bp, Hll, bl, W) from its observation shard and one
psum combines them; the tiny reduced solve then runs replicated on every
device.

The compiled solver is CACHED per (params, n_fixed, mesh, shapes): the
assembly/GN loop jits once and every subsequent solve of the same window
shape hits the executable cache (a per-call jit wrapper was recompiling
the whole GN loop on every poseframe). The GN driver itself is
schur.gn_solve — one definition shared with the single-device path.

Multi-controller (jax.distributed) meshes are supported: inputs are
converted to global arrays with jax.make_array_from_callback (every
process holds the identical window data, the callback serves each
process's addressable shards), exercised by the 2-process test in
tests/test_multihost.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flame_tpu.ba import residuals as resid
from flame_tpu.ba import schur
from flame_tpu.params import BAParams
from flame_tpu.parallel.sharding import AXIS


@functools.lru_cache(maxsize=32)
def _make_solver(params: BAParams, n_fixed: int, mesh: Mesh,
                 P_n: int, L: int, M: int):
    """Compiled observation-sharded GN solver for one window shape."""
    rep = P()
    oshard = resid.BAObservations(
        anchor_idx=P(AXIS), obs_idx=P(AXIS), lm_idx=P(AXIS),
        u_ref=P(AXIS), u_obs=P(AXIS), valid=P(AXIS))

    def assemble_body(K, Kinv, q, t, lm, obs, sw):
        Hpp, bp, Hll, bl, W, cost = schur._assemble(
            K, Kinv, q, t, lm, obs, params.huber_delta, P_n, L, sqrtW=sw)
        return (jax.lax.psum(Hpp, AXIS), jax.lax.psum(bp, AXIS),
                jax.lax.psum(Hll, AXIS), jax.lax.psum(bl, AXIS),
                jax.lax.psum(W, AXIS), jax.lax.psum(cost, AXIS))

    assemble_sm = jax.shard_map(
        assemble_body, mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep, oshard, P(AXIS)),
        out_specs=(rep, rep, rep, rep, rep, rep))

    def run(K, Kinv, problem, sqrtW):
        def assemble(q, t, lm):
            return assemble_sm(K, Kinv, q, t, lm, problem.obs, sqrtW)
        return schur.gn_solve(params, problem, n_fixed, problem.lm_valid,
                              assemble)

    return jax.jit(run)


def _to_global(mesh: Mesh, spec, arr):
    """Place a process-locally identical array onto a (possibly
    multi-controller) mesh: every process holds the full value, the
    callback serves whatever slice each addressable device needs."""
    arr = jnp.asarray(arr)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    host = np.asarray(arr)
    return jax.make_array_from_callback(host.shape, sharding,
                                        lambda idx: host[idx])


def solve_window_sharded(params: BAParams, K, Kinv,
                         problem: schur.BAProblem, mesh: Mesh,
                         n_fixed: int = 2, sqrtW=None):
    """solve_window with the assembly sharded over the mesh.

    Observation rows are padded (valid=False) up to a multiple of the
    mesh axis (there is no silent divisibility fallback).
    sqrtW is per-observation whitening ((M, 2, 2),
    ba/rematch.observation_weights) and shards with the observations.
    Numerically equivalent to the single-device solve up to float
    reduction order.
    """
    n_dev = int(mesh.shape[AXIS])
    M = problem.obs.u_ref.shape[0]
    pad = (-M) % n_dev
    if pad:
        obs = problem.obs
        problem = problem._replace(obs=resid.BAObservations(
            anchor_idx=jnp.pad(obs.anchor_idx, (0, pad)),
            obs_idx=jnp.pad(obs.obs_idx, (0, pad)),
            lm_idx=jnp.pad(obs.lm_idx, (0, pad)),
            u_ref=jnp.pad(obs.u_ref, ((0, pad), (0, 0))),
            u_obs=jnp.pad(obs.u_obs, ((0, pad), (0, 0))),
            valid=jnp.pad(obs.valid, (0, pad))))
        if sqrtW is not None:
            sqrtW = jnp.pad(sqrtW, ((0, pad), (0, 0), (0, 0)))
    M = M + pad

    # One sharded assembly path: absent whitening is the identity (the
    # (M, 2, 2) broadcast is noise next to the Jacobian work). Priors
    # are materialized so the jitted pytree structure is stable.
    if sqrtW is None:
        sqrtW = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), (M, 2, 2))
    problem = problem._replace(
        prior_q=problem.prior_q if problem.prior_q is not None
        else problem.q,
        prior_t=problem.prior_t if problem.prior_t is not None
        else problem.t)

    # Global placement: observations (and sqrtW) sharded on the mesh
    # axis, everything else replicated.
    oshard = resid.BAObservations(
        anchor_idx=P(AXIS), obs_idx=P(AXIS), lm_idx=P(AXIS),
        u_ref=P(AXIS), u_obs=P(AXIS), valid=P(AXIS))
    problem = schur.BAProblem(
        q=_to_global(mesh, P(), problem.q),
        t=_to_global(mesh, P(), problem.t),
        lm_idepth=_to_global(mesh, P(), problem.lm_idepth),
        lm_valid=_to_global(mesh, P(), problem.lm_valid),
        obs=jax.tree.map(lambda a, s: _to_global(mesh, s, a),
                         problem.obs, oshard),
        prior_q=_to_global(mesh, P(), problem.prior_q),
        prior_t=_to_global(mesh, P(), problem.prior_t))
    sqrtW = _to_global(mesh, P(AXIS), sqrtW)
    Kg = _to_global(mesh, P(), K)
    Kinvg = _to_global(mesh, P(), Kinv)

    L = problem.lm_idepth.shape[0]
    P_n = problem.q.shape[0]
    run = _make_solver(params, n_fixed, mesh, P_n, L, M)
    return run(Kg, Kinvg, problem, sqrtW)
