"""Multi-device sharding of the dense-mapping pipeline.

The reference has no distributed computation of any kind (SURVEY.md
section 0); this layer is the scale-out across devices:

  * Feature-parallel tracking (the DP axis): feature slots are block-
    partitioned across devices with shard_map; images/poses are replicated.
    Tracking is embarrassingly parallel over features (the reference's
    OpenMP loop, flame.cc:1307).
  * Edge-parallel smoothing (the TP/graph axis): the NLTGV2 dual step and
    per-edge primal contributions are computed on each device's edge shard;
    per-vertex sums are combined with one psum over the interconnect per
    iteration, after which the (replicated) vertex update is computed
    identically everywhere. This is the reduction formulation of the
    graph solve — vertices never move.

Both shardings compose into one jitted update step (sharded_update_step)
used by the multi-device dry run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flame_tpu.optimize import nltgv2
from flame_tpu.params import Params, RegularizerParams
from flame_tpu.core import pipeline
from flame_tpu.core.frame import Frame, FrameStack

AXIS = "graph"

# Interconnect traffic of the most recently TRACED sharded_smooth config
# (assigned at trace time only — cached executions do not update it;
# for multi-config telemetry call psum_traffic_model directly).
LAST_TRAFFIC = None


def psum_traffic_model(V: int, n_dev: int, n_iters: int,
                       dtype_bytes: int = 4) -> dict:
    """Analytical interconnect traffic of the edge-sharded smoother: one (V, 3)
    float32 psum per iteration. A ring all-reduce moves ~2(n-1)/n of the
    payload through each device — O(V) VOLUME scaling, the contrast to
    the halo smoother's O(1) boundary exchange (halo.traffic_model)."""
    payload = V * 3 * dtype_bytes
    per_dev = int(2 * (n_dev - 1) / max(n_dev, 1) * payload)
    return {
        "smoother": "edge_psum",
        "n_devices": n_dev,
        "edge_rows_per_device": None,  # set by caller (E // n)
        "collectives_per_iter": 1,  # one (V, 3) psum
        "bytes_per_device_per_iter": per_dev,
        "bytes_per_device_total": per_dev * n_iters,
        "bytes_all_devices_total": per_dev * n_iters * n_dev,
    }


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


# ---------------------------------------------------------------------------
# Edge-sharded NLTGV2 smoothing.
# ---------------------------------------------------------------------------


def _sharded_smooth_body(p: RegularizerParams, n_iters: int,
                         pos, x, w1, w2, x_bar, w1_bar, w2_bar,
                         data_term, data_weight, vtx_mask,
                         edges, alpha, beta, q1, q2, q3, edge_mask):
    """shard_map body: vertex arrays replicated, edge arrays sharded.

    Runs n_iters Chambolle-Pock iterations with one (V, 3) psum per
    iteration, using the same stacked gather-minimized formulation as the
    single-device hot loop (nltgv2._smooth_stacked): two row gathers of the
    replicated (V, 8) bar-state per local edge shard, two row segment-sums,
    then the psum combines the shards' vertex contributions.
    """
    V = x.shape[0]
    ii = edges[:, 0]
    jj = edges[:, 1]

    # Loop-invariant per-edge quantities on the local shard.
    dx = pos[ii, 0] - pos[jj, 0]
    dy = pos[ii, 1] - pos[jj, 1]
    a = jnp.where(edge_mask, alpha, 0.0)
    b = jnp.where(edge_mask, beta, 0.0)
    sxa = p.step_x * a
    sxb = p.step_x * b
    qa = p.step_q * a
    qb = p.step_q * b
    weight = p.data_factor * data_weight
    zcol = jnp.zeros((V,), jnp.float32)

    def pack(xb, w1b, w2b):
        return jnp.stack([xb, w1b, w2b, zcol, zcol, zcol, zcol, zcol],
                         axis=1)

    def one_iter(_, state):
        x, w1, w2, VB, q1, q2, q3 = state
        x_prev, w1_prev, w2_prev = x, w1, w2

        gi = VB[ii]
        gj = VB[jj]

        K1 = (gi[:, 0] - gj[:, 0]) - dx * gi[:, 1] - dy * gi[:, 2]
        nq1 = nltgv2._prox_nltgv2_conj(q1 + qa * K1)
        nq2 = nltgv2._prox_nltgv2_conj(q2 + qb * (gi[:, 1] - gj[:, 1]))
        nq3 = nltgv2._prox_nltgv2_conj(q3 + qb * (gi[:, 2] - gj[:, 2]))

        Ci = jnp.stack([-nq1 * sxa,
                        nq1 * sxa * dx - nq2 * sxb,
                        nq1 * sxa * dy - nq3 * sxb], axis=1)
        Cj = jnp.stack([nq1 * sxa, nq2 * sxb, nq3 * sxb], axis=1)

        S = jax.ops.segment_sum(Ci, ii, num_segments=V) + \
            jax.ops.segment_sum(Cj, jj, num_segments=V)
        S = jax.lax.psum(S, AXIS)  # combine edge shards

        nx = x + S[:, 0]
        nw1 = w1 + S[:, 1]
        nw2 = w2 + S[:, 2]

        nx = nltgv2._prox_l1(p.x_min, p.x_max, p.step_x, weight, nx,
                             data_term)
        nx = jnp.where(vtx_mask, nx, x)
        nw1 = jnp.where(vtx_mask, nw1, w1)
        nw2 = jnp.where(vtx_mask, nw2, w2)

        # Extragradient (replicated; identical on every device).
        x_bar = jnp.clip(nx + p.theta * (nx - x_prev), p.x_min, p.x_max)
        w1_bar = nw1 + p.theta * (nw1 - w1_prev)
        w2_bar = nw2 + p.theta * (nw2 - w2_prev)

        return (nx, nw1, nw2, pack(x_bar, w1_bar, w2_bar), nq1, nq2, nq3)

    state = (x, w1, w2, pack(x_bar, w1_bar, w2_bar), q1, q2, q3)
    state = jax.lax.fori_loop(0, n_iters, one_iter, state)
    x, w1, w2, VB, q1, q2, q3 = state
    em = edge_mask
    return (x, w1, w2, VB[:, 0], VB[:, 1], VB[:, 2],
            jnp.where(em, q1, 0.0), jnp.where(em, q2, 0.0),
            jnp.where(em, q3, 0.0))


def sharded_smooth(p: RegularizerParams, g: nltgv2.GraphState, n_iters: int,
                   mesh: Mesh) -> nltgv2.GraphState:
    """Run n_iters edge-sharded smoothing iterations over the mesh.

    Edge capacity must divide the mesh size. Numerically identical to
    nltgv2.smooth (up to float reduction order).
    """
    global LAST_TRAFFIC
    LAST_TRAFFIC = psum_traffic_model(g.x.shape[0],
                                      int(mesh.devices.size), n_iters)
    LAST_TRAFFIC["edge_rows_per_device"] = \
        g.q1.shape[0] // int(mesh.devices.size)
    rep = P()
    eshard = P(AXIS)
    body = functools.partial(_sharded_smooth_body, p, n_iters)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep, rep, rep, rep, rep, rep,
                  eshard, eshard, eshard, eshard, eshard, eshard, eshard),
        out_specs=(rep,) * 6 + (eshard,) * 3)
    x, w1, w2, x_bar, w1_bar, w2_bar, q1, q2, q3 = fn(
        g.pos, g.x, g.w1, g.w2, g.x_bar, g.w1_bar, g.w2_bar,
        g.data_term, g.data_weight, g.vtx_mask,
        g.edges, g.alpha, g.beta, g.q1, g.q2, g.q3, g.edge_mask)
    return g._replace(x=x, w1=w1, w2=w2, x_bar=x_bar, w1_bar=w1_bar,
                      w2_bar=w2_bar, q1=q1, q2=q2, q3=q3)


# ---------------------------------------------------------------------------
# Feature-sharded tracking + edge-sharded smoothing: the full sharded
# per-frame step (used by the multi-device dry run).
# ---------------------------------------------------------------------------


def sharded_update_step(params: Params, mesh: Mesh, smoother: str = "edge"):
    """Build a jitted multi-device per-frame step.

    Returns step(K, Kinv, stack, feats, fnew, curr_pf_slot, graph,
    [perm, inv_perm, ranks_p]) -> (feats', curr, member, graph', stats)
    where feature arrays are sharded over the mesh axis for tracking (DP)
    and the smoothing iterations run either edge-sharded with a per-
    iteration psum (smoother="edge", replicated vertices) or vertex-
    partitioned with halo exchange (smoother="halo" — pass the RCM
    perm/inv/ranks trailing args; see parallel/halo.py).
    """
    n_dev = mesh.devices.size
    assert params.feature_capacity % n_dev == 0, "feature capacity % devices"
    assert params.edge_capacity % n_dev == 0, "edge capacity % devices"

    def track_body(K, Kinv, stack, feats, fnew, curr_pf_slot):
        # Per-shard tracking over the local feature block. The gate/member
        # logic is elementwise over features, so block partitioning is
        # exact.
        return pipeline.track_project_sync.__wrapped__(
            params, K, Kinv, stack, feats, fnew, curr_pf_slot)

    rep = P()
    fshard_tree = jax.tree_util.tree_map(
        lambda _: P(AXIS), pipeline.empty_features(params.feature_capacity))
    curr_shard = pipeline.CurrFeatures(
        xy=P(AXIS), idepth=P(AXIS), var=P(AXIS), valid=P(AXIS))
    obs_shard = pipeline.TrackObs(success=P(AXIS), u_ref=P(AXIS),
                                  u_obs=P(AXIS), idepth=P(AXIS), var=P(AXIS))

    stack_rep = jax.tree_util.tree_map(
        lambda _: P(), FrameStack(*[0] * len(FrameStack._fields)))
    frame_rep = jax.tree_util.tree_map(
        lambda _: P(), Frame(*[0] * len(Frame._fields)))

    tracked = jax.shard_map(
        track_body, mesh=mesh,
        in_specs=(rep, rep, stack_rep, fshard_tree, frame_rep, rep),
        out_specs=(fshard_tree, curr_shard, P(AXIS), P(AXIS), obs_shard))

    if smoother == "halo":
        from flame_tpu.parallel import halo as halo_mod

        def step(K, Kinv, stack, feats, fnew, curr_pf_slot, graph,
                 perm, inv_perm, ranks_p):
            feats2, curr, member, stats, _obs = tracked(
                K, Kinv, stack, feats, fnew, curr_pf_slot)
            graph2 = halo_mod.halo_smooth(
                params.rparams, graph, perm, inv_perm, ranks_p,
                params.solver.n_iters_per_frame,
                params.solver.max_vertex_degree, mesh,
                halo=halo_mod.strip_width(params.feature_capacity, n_dev,
                                          params.solver.pallas_reach))
            stats = jnp.sum(stats.reshape(n_dev, -1), axis=0)
            return feats2, curr, member, graph2, stats

        return jax.jit(step)

    def step(K, Kinv, stack, feats, fnew, curr_pf_slot, graph):
        feats2, curr, member, stats, _obs = tracked(K, Kinv, stack, feats,
                                                    fnew, curr_pf_slot)
        graph2 = sharded_smooth(params.rparams, graph,
                                params.solver.n_iters_per_frame, mesh)
        stats = jnp.sum(stats.reshape(n_dev, -1), axis=0)
        return feats2, curr, member, graph2, stats

    return jax.jit(step)
