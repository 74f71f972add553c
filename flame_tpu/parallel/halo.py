"""Vertex-partitioned NLTGV2 smoothing with halo exchange between devices.

The edge-sharded smoother (parallel/sharding.py) replicates the vertex
state and all-reduces a (V, 3) sum every iteration, so its collective
payload grows with V. This module partitions the VERTICES instead
(SURVEY.md section 5: "partition keyframes and mesh blocks across
devices/hosts; halo-exchange graph-boundary dual variables each smoothing
iteration"):

  * Vertices are RCM-ordered on the host (rcm_order below) so every edge
    spans at most `halo` ranks, then block-partitioned contiguously across
    the mesh axis.
  * Each device owns its vertex block plus read-only halo copies of the
    adjacent blocks' boundary strips. The vertex-centric both-copies
    formulation (each endpoint keeps a local copy of its edges' duals)
    makes the halo read-only: no scatter ever crosses the boundary.
  * Per iteration, the updated boundary strips of the extragradient state
    travel to the two neighbor devices with 2 ppermutes of (halo, 3)
    floats (~9 KB at halo=384) — constant per device as V grows, vs the
    O(V) psum of the edge-sharded formulation.

Semantics match nltgv2.step: edges whose endpoints end up more than
`halo` ranks apart are dropped consistently on both sides for the call.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from flame_tpu.optimize import nltgv2
from flame_tpu.params import RegularizerParams

AXIS = "graph"

# Interconnect traffic of the most recently TRACED halo_smooth configuration.
# Assigned at trace time only — executions served from the jit cache do
# not update it (the numbers are static per configuration; for live
# telemetry across multiple configs, call traffic_model directly with
# your config instead of reading this).
LAST_TRAFFIC = None

# Rank-row width of the RCM band: perm_edge_ranks keeps an edge when its
# endpoints' ranks lie within `reach` rows of LANES ranks of each other.
LANES = 128


def strip_width(v_cap: int, n_dev: int, reach: int) -> int:
    """The halo strip width halo_smooth runs with in the pipeline: the
    band the RCM rank build targets, clamped to the per-device block.
    ONE definition — pipeline.post_delaunay's halo_smooth call and
    flame._host_triangulate's drop counter must use the same number or
    the edges_band_dropped stat silently diverges from what rank_layout
    kills."""
    return min(v_cap // n_dev, (reach + 1) * LANES)


def traffic_model(V: int, n_dev: int, n_iters: int, halo: int,
                  dtype_bytes: int = 4) -> dict:
    """Analytical interconnect traffic of one halo_smooth call — exact, because
    the exchange is structural: per iteration each device ppermutes its
    two boundary strips of the (halo, 3) bar-state to its neighbors,
    INDEPENDENT of V (boundary scaling, not volume scaling; contrast the
    edge-sharded smoother's O(V) psum, sharding.py).
    tests/test_scaling_model.py sweeps it on virtual meshes."""
    strip = halo * 3 * dtype_bytes  # one boundary strip of xb/w1b/w2b
    return {
        "smoother": "halo",
        "n_devices": n_dev,
        "block_rows_per_device": V // n_dev,  # per-device work ~ V/n
        "collectives_per_iter": 2,  # two ppermutes (left + right strip)
        "bytes_per_device_per_iter": 2 * strip,
        "bytes_per_device_total": 2 * strip * n_iters,
        "bytes_all_devices_total": 2 * strip * n_iters * n_dev,
    }


def rank_layout(g: nltgv2.GraphState, perm, inv_perm, ranks_p, degree: int,
                halo: int):
    """Rank-space SoA layout for the halo smoother.

    Returns (vtx 9-tuple of (V,) rank-ordered arrays, slots 10-tuple of
    (V, D) arrays [nbr global-rank, sdx, sdy, sal, sbe, sgn, srcf, q1,
    q2, q3], src_slot (E,) flat v*D+d of each edge's lo-copy for dual
    write-back, alive (E,) bool). ranks_p from perm_edge_ranks
    (255 = dropped)."""
    V = g.x.shape[0]
    D = degree

    def vp(a):
        return a[perm]

    vtx = (vp(g.x), vp(g.w1), vp(g.w2), vp(g.x_bar), vp(g.w1_bar),
           vp(g.w2_bar), vp(g.data_term), vp(g.data_weight),
           vp(g.vtx_mask.astype(jnp.float32)))

    lo = g.edges[:, 0]
    hi = g.edges[:, 1]
    lo_p = inv_perm[lo]
    hi_p = inv_perm[hi]
    sr = ranks_p[:, 0]
    dr = ranks_p[:, 1]
    alive = (g.edge_mask & (jnp.abs(lo_p - hi_p) <= halo)
             & (sr < D) & (dr < D))

    d = g.pos[lo] - g.pos[hi]
    sent = V * D
    slot_s = jnp.where(alive, lo_p * D + sr, sent)
    slot_d = jnp.where(alive, hi_p * D + dr, sent)

    def scat2(vals_s, vals_d, dtype=jnp.float32):
        buf = jnp.zeros((V * D + 1,), dtype)
        buf = buf.at[slot_s].set(vals_s, mode="drop")
        buf = buf.at[slot_d].set(vals_d, mode="drop")
        return buf[:-1].reshape(V, D)

    alpha = jnp.where(alive, g.alpha, 0.0)
    beta = jnp.where(alive, g.beta, 0.0)
    one = jnp.where(alive, 1.0, 0.0)
    slots = (scat2(hi_p, lo_p, jnp.int32),
             scat2(d[:, 0], d[:, 0]), scat2(d[:, 1], d[:, 1]),
             scat2(alpha, alpha), scat2(beta, beta),
             scat2(one, -one), scat2(one, jnp.zeros_like(one)),
             scat2(g.q1, g.q1), scat2(g.q2, g.q2), scat2(g.q3, g.q3))
    return vtx, slots, jnp.where(alive, lo_p * D + sr, sent), alive


def _body(p: RegularizerParams, n_iters: int, halo: int,
          x, w1, w2, xb, w1b, w2b, data, weight, vmaskf,
          nbr, sdx, sdy, sal, sbe, sgn, srcf, q1, q2, q3):
    """shard_map body over the vertex-block axis."""
    Vb = x.shape[0]
    D = nbr.shape[1]
    idx = jax.lax.axis_index(AXIS)
    n_dev = jax.lax.axis_size(AXIS)
    block_start = idx * Vb

    is_src = srcf > 0.0
    sxa = p.step_x * sal
    sxb = p.step_x * sbe
    qa = p.step_q * sal
    qb = p.step_q * sbe
    vmask = vmaskf > 0.0
    wgt = p.data_factor * weight
    # Local index into the halo-extended bar-state array.
    nbr_ext = jnp.clip(nbr - block_start + halo, 0, Vb + 2 * halo - 1)

    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [((i + 1) % n_dev, i) for i in range(n_dev)]

    def extend(VB):
        """(Vb, 3) -> (Vb + 2*halo, 3): halo strips from the neighbors.
        Ring wrap-around delivers garbage to the end devices' outer halos,
        but no edge references them (global ranks < 0 / >= V do not
        exist)."""
        left = jax.lax.ppermute(VB[-halo:], AXIS, fwd)
        right = jax.lax.ppermute(VB[:halo], AXIS, bwd)
        return jnp.concatenate([left, VB, right], axis=0)

    def one_iter(_, state):
        x, w1, w2, VB, q1, q2, q3 = state
        x_prev, w1_prev, w2_prev = x, w1, w2

        ext = extend(VB)
        nb = ext[nbr_ext]  # (Vb, D, 3)
        xb_n, w1b_n, w2b_n = nb[..., 0], nb[..., 1], nb[..., 2]
        xb_s = VB[:, None, 0]
        w1b_s = VB[:, None, 1]
        w2b_s = VB[:, None, 2]

        xb_i = jnp.where(is_src, xb_s, xb_n)
        xb_j = jnp.where(is_src, xb_n, xb_s)
        w1b_i = jnp.where(is_src, w1b_s, w1b_n)
        w1b_j = jnp.where(is_src, w1b_n, w1b_s)
        w2b_i = jnp.where(is_src, w2b_s, w2b_n)
        w2b_j = jnp.where(is_src, w2b_n, w2b_s)

        K1 = (xb_i - xb_j) - sdx * w1b_i - sdy * w2b_i
        nq1 = nltgv2._prox_nltgv2_conj(q1 + qa * K1)
        nq2 = nltgv2._prox_nltgv2_conj(q2 + qb * (w1b_i - w1b_j))
        nq3 = nltgv2._prox_nltgv2_conj(q3 + qb * (w2b_i - w2b_j))

        d_x = -sgn * nq1 * sxa
        d_w1 = jnp.where(is_src, nq1 * sxa * sdx, 0.0) - sgn * nq2 * sxb
        d_w2 = jnp.where(is_src, nq1 * sxa * sdy, 0.0) - sgn * nq3 * sxb

        nx = x + d_x.sum(1)
        nw1 = w1 + d_w1.sum(1)
        nw2 = w2 + d_w2.sum(1)

        nx = nltgv2._prox_l1(p.x_min, p.x_max, p.step_x, wgt, nx, data)
        nx = jnp.where(vmask, nx, x)
        nw1 = jnp.where(vmask, nw1, w1)
        nw2 = jnp.where(vmask, nw2, w2)

        nxb = jnp.clip(nx + p.theta * (nx - x_prev), p.x_min, p.x_max)
        nw1b = nw1 + p.theta * (nw1 - w1_prev)
        nw2b = nw2 + p.theta * (nw2 - w2_prev)
        return (nx, nw1, nw2, jnp.stack([nxb, nw1b, nw2b], axis=1),
                nq1, nq2, nq3)

    init = (x, w1, w2, jnp.stack([xb, w1b, w2b], axis=1), q1, q2, q3)
    out = jax.lax.fori_loop(0, n_iters, one_iter, init)
    x, w1, w2, VB, q1, q2, q3 = out
    return (x, w1, w2, VB[:, 0], VB[:, 1], VB[:, 2], q1, q2, q3)


def halo_smooth(p: RegularizerParams, g: nltgv2.GraphState, perm, inv_perm,
                ranks_p, n_iters: int, degree: int, mesh: Mesh,
                halo: int = 384) -> nltgv2.GraphState:
    """Run n_iters vertex-partitioned smoothing iterations over the mesh.

    perm/inv_perm/ranks_p come from rcm_order / perm_edge_ranks (with
    reach = ceil(halo / LANES) - 1). V must divide the mesh size with
    block >= halo."""
    V = g.x.shape[0]
    n_dev = mesh.devices.size
    assert V % n_dev == 0, "vertex capacity % devices"
    assert V // n_dev >= halo, "halo wider than a vertex block"
    global LAST_TRAFFIC
    LAST_TRAFFIC = traffic_model(V, int(n_dev), n_iters, halo)

    vtx, slots, src_slot_p, alive = rank_layout(g, perm, inv_perm, ranks_p,
                                                degree, halo)
    vshard = P(AXIS)
    body = functools.partial(_body, p, n_iters, halo)
    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(vshard,) * 19, out_specs=(vshard,) * 9)
    outs = fn(*vtx[:9], *slots)

    x, w1, w2, xb, w1b, w2b = [o[inv_perm] for o in outs[:6]]

    def unslot(qs):
        return jnp.pad(qs.reshape(-1), (0, 1))[src_slot_p]

    em = g.edge_mask
    q1 = jnp.where(alive, unslot(outs[6]), g.q1)
    q2 = jnp.where(alive, unslot(outs[7]), g.q2)
    q3 = jnp.where(alive, unslot(outs[8]), g.q3)
    return g._replace(x=x, w1=w1, w2=w2, x_bar=xb, w1_bar=w1b, w2_bar=w2b,
                      q1=jnp.where(em, q1, 0.0),
                      q2=jnp.where(em, q2, 0.0),
                      q3=jnp.where(em, q3, 0.0))


# ---------------------------------------------------------------------------
# Host-side helpers (numpy; run in the triangulation worker thread).
# ---------------------------------------------------------------------------


def rcm_order(edges: np.ndarray, n_valid_edges: int, v_cap: int,
              member: np.ndarray) -> np.ndarray:
    """Bandwidth-reducing vertex ordering: perm (V,) rank -> vertex slot.

    Members are ordered by reverse Cuthill-McKee over the edge graph
    (scipy when available, BFS fallback); non-members fill the tail.
    """
    e = edges[:n_valid_edges]
    perm_members = _rcm(e, v_cap, member)
    # _rcm returns exactly the member nodes, so the non-member tail is
    # disjoint by construction.
    rest = np.nonzero(~member)[0]
    perm = np.concatenate([perm_members, rest]).astype(np.int32)
    assert perm.shape[0] == v_cap
    return perm


def _rcm(e: np.ndarray, v_cap: int, member: np.ndarray) -> np.ndarray:
    nodes = np.nonzero(member)[0]
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        n = nodes.shape[0]
        dense_id = np.full(v_cap, -1, np.int64)
        dense_id[nodes] = np.arange(n)
        a = dense_id[e[:, 0]]
        b = dense_id[e[:, 1]]
        ok = (a >= 0) & (b >= 0)
        A = sp.coo_matrix((np.ones(ok.sum(), np.int8), (a[ok], b[ok])),
                          shape=(n, n)).tocsr()
        A = A + A.T
        order = reverse_cuthill_mckee(A, symmetric_mode=True)
        return nodes[order].astype(np.int32)
    except ImportError:
        return _bfs_order(e, v_cap, nodes)


def _bfs_order(e: np.ndarray, v_cap: int, nodes: np.ndarray) -> np.ndarray:
    """Plain BFS ordering fallback (bounded-degree planar graphs get
    near-sqrt bandwidth from BFS levels)."""
    adj = collections.defaultdict(list)
    nodeset = set(int(x) for x in nodes)
    for a, b in e:
        a, b = int(a), int(b)
        if a in nodeset and b in nodeset:
            adj[a].append(b)
            adj[b].append(a)
    seen = set()
    order = []
    for seed in nodes:
        s = int(seed)
        if s in seen:
            continue
        dq = collections.deque([s])
        seen.add(s)
        while dq:
            u = dq.popleft()
            order.append(u)
            for w in sorted(adj[u]):
                if w not in seen:
                    seen.add(w)
                    dq.append(w)
    return np.asarray(order, np.int32)


def perm_edge_ranks(edges: np.ndarray, n_e: int, inv_perm: np.ndarray,
                    e_cap: int, degree: int,
                    reach: int = 2, tie=None) -> np.ndarray:
    """(E, 2) uint8 [src_rank, dst_rank] of each edge among its permuted
    lo/hi vertex's incident edges. Edges whose endpoints' rank rows
    (rank // LANES) differ by more than `reach`, or that overflow
    `degree` on EITHER side, get 255 on both (dropped
    consistently — unlike one-sided truncation, this keeps the two dual
    copies identical). tie: optional per-edge sort key (e.g. length)
    ordering each vertex's incident edges within its slot block, so
    degree overflow drops the weakest couplings first."""
    ranks = np.full((e_cap, 2), 255, np.uint8)
    if n_e == 0:
        return ranks
    lo_p = inv_perm[edges[:n_e, 0]].astype(np.int64)
    hi_p = inv_perm[edges[:n_e, 1]].astype(np.int64)
    v_cap = inv_perm.shape[0]
    band_ok = np.abs(lo_p // LANES - hi_p // LANES) <= reach

    from flame_tpu.optimize.topology import rank_within
    sr = rank_within(lo_p, tie)
    # dst entries live ABOVE the vertex's src entries in its slot range so
    # the two never collide (same scheme as topology.build_edge_ranks).
    n_src = np.bincount(lo_p, minlength=v_cap)
    dr = n_src[hi_p] + rank_within(hi_p, tie)
    ok = band_ok & (sr < degree) & (dr < degree)
    ranks[:n_e, 0] = np.where(ok, sr, 255).astype(np.uint8)
    ranks[:n_e, 1] = np.where(ok, dr, 255).astype(np.uint8)
    return ranks
