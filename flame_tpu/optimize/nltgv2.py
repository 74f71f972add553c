"""NLTGV2-L1 variational smoothing on padded edge-list graphs.

JAX re-design of the reference's Chambolle-Pock primal-dual solver
over a Boost adjacency_list
(/root/reference/src/flame/optimizers/nltgv2_l1_graph_regularizer.cc).

The energy (see the reference's header docs) is

    min_x  data_factor * NLTGV2(x, w1, w2) + sum_v weight_v |x_v - data_v|

where NLTGV2 couples per-vertex primal state (x, w1, w2) along graph edges
with per-edge dual state (q1, q2, q3). One iteration = dual ascent with a
unit-ball projection, primal descent via edge-scatter, an L1 proximal step
on the data term, and a theta-overrelaxed extragradient
(reference .cc:33-174, reproduced op-for-op).

Instead of hash-map graph surgery, the graph lives in fixed-capacity
structure-of-arrays: vertices [V] with a validity mask, edges [E, 2] of
int32 slot indices with a validity mask. Invalid edges are parked on
vertex 0 with zero weights so they contribute exactly nothing. Two primal
scatter implementations are provided:

  * segment-sum (reference implementation, always correct), and
  * incidence-gather: a host-built [V, D] table of incident edge ids +
    signs turns the scatter into pure gathers — the fast path (gathers
    vectorize; scatters serialize or need atomics). `smooth()` picks
    incidence when the table is present.

`smooth()` runs K iterations inside one jit/fori_loop — the deterministic
replacement for the reference's free-running graph thread
(flame.cc:98-112).
"""

import functools
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from flame_tpu.params import RegularizerParams


class GraphState(NamedTuple):
    """Fixed-capacity SoA graph (reference VertexData/EdgeData,
    nltgv2_l1_graph_regularizer.h:74-102)."""

    # Vertex arrays [V].
    pos: jax.Array  # (V, 2) pixel positions
    x: jax.Array  # primal
    w1: jax.Array
    w2: jax.Array
    x_bar: jax.Array  # extragradient
    w1_bar: jax.Array
    w2_bar: jax.Array
    data_term: jax.Array
    data_weight: jax.Array
    vtx_mask: jax.Array  # bool

    # Edge arrays [E].
    edges: jax.Array  # (E, 2) int32 endpoint slots (0 when invalid)
    alpha: jax.Array  # 1/edge_length (0 when invalid)
    beta: jax.Array  # 1.0 (0 when invalid)
    q1: jax.Array  # duals
    q2: jax.Array
    q3: jax.Array
    edge_mask: jax.Array  # bool

    # Optional incidence table [V, D] for the gather-based primal step.
    inc_edge: Optional[jax.Array] = None  # int32 edge ids (0 pad)
    inc_sign: Optional[jax.Array] = None  # +1 src, -1 dst, 0 pad
    # Optional [E] flat (V*D) incidence slot of each edge's src-endpoint
    # entry (see topology._build_incidence_device) for the vertex-centric
    # smoother's dual write-back.
    src_slot: Optional[jax.Array] = None


def empty(v_capacity: int, e_capacity: int, degree: int = 0) -> GraphState:
    z = jnp.zeros(v_capacity, jnp.float32)
    ze = jnp.zeros(e_capacity, jnp.float32)
    inc_edge = (jnp.zeros((v_capacity, degree), jnp.int32)
                if degree else None)
    inc_sign = (jnp.zeros((v_capacity, degree), jnp.float32)
                if degree else None)
    src_slot = (jnp.full((e_capacity,), v_capacity * degree, jnp.int32)
                if degree else None)
    return GraphState(
        pos=jnp.zeros((v_capacity, 2), jnp.float32),
        x=z, w1=z, w2=z, x_bar=z, w1_bar=z, w2_bar=z,
        data_term=z, data_weight=z,
        vtx_mask=jnp.zeros(v_capacity, bool),
        edges=jnp.zeros((e_capacity, 2), jnp.int32),
        alpha=ze, beta=ze, q1=ze, q2=ze, q3=ze,
        edge_mask=jnp.zeros(e_capacity, bool),
        inc_edge=inc_edge, inc_sign=inc_sign, src_slot=src_slot)


def build_incidence(edges: np.ndarray, edge_mask: np.ndarray,
                    n_vertices: int, max_degree: int):
    """Host-side: build the per-vertex incident-edge table.

    edges: (E, 2) int; edge_mask: (E,) bool. Returns (inc_edge (V, D) int32,
    inc_sign (V, D) float32). Overflow beyond max_degree is dropped (planar
    Delaunay degree rarely exceeds ~10; choose D with headroom).
    """
    V, D = n_vertices, max_degree
    inc_edge = np.zeros((V, D), np.int32)
    inc_sign = np.zeros((V, D), np.float32)
    eidx = np.nonzero(edge_mask)[0]
    if eidx.shape[0] == 0:
        return inc_edge, inc_sign
    # Vectorized fill: sort (vertex, edge-id, sign) triples by vertex, rank
    # within each vertex group, scatter ranks < D.
    verts = np.concatenate([edges[eidx, 0], edges[eidx, 1]])
    eids = np.concatenate([eidx, eidx]).astype(np.int32)
    signs = np.concatenate([np.ones(eidx.shape[0], np.float32),
                            -np.ones(eidx.shape[0], np.float32)])
    order = np.argsort(verts, kind="stable")
    vs = verts[order]
    first = np.searchsorted(vs, vs, side="left")
    rank = np.arange(vs.shape[0]) - first
    keep = rank < D
    inc_edge[vs[keep], rank[keep]] = eids[order][keep]
    inc_sign[vs[keep], rank[keep]] = signs[order][keep]
    return inc_edge, inc_sign


def build_src_slot(inc_edge: np.ndarray, inc_sign: np.ndarray,
                   e_capacity: int) -> np.ndarray:
    """Host-side companion to build_incidence: per-edge flat (V*D) slot of
    its src-endpoint incidence entry (dst fallback, V*D sentinel when
    absent) — required by the vertex-centric smoother's dual write-back."""
    V, D = inc_edge.shape
    src_slot = np.full(e_capacity, V * D, np.int32)
    flat_e = inc_edge.reshape(-1)
    flat_s = inc_sign.reshape(-1)
    dst = np.nonzero(flat_s < 0)[0]
    src_slot[flat_e[dst]] = dst
    src = np.nonzero(flat_s > 0)[0]
    src_slot[flat_e[src]] = src
    return src_slot


# ---------------------------------------------------------------------------
# One Chambolle-Pock iteration.
# ---------------------------------------------------------------------------


def _prox_nltgv2_conj(q):
    """Project duals onto the unit ball (reference .h:171-176)."""
    absq = jnp.abs(q)
    return q / jnp.maximum(absq, 1.0)


def _prox_l1(x_min, x_max, step_x, weight, x, data):
    """Soft-threshold toward the data term, clamped to the feasible set
    (reference .h:179-197)."""
    diff = x - data
    thresh = step_x * weight
    new_x = jnp.where(diff > thresh, x - thresh,
                      jnp.where(diff < -thresh, x + thresh, data))
    return jnp.clip(new_x, x_min, x_max)


def _dual_step(p: RegularizerParams, g: GraphState):
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    dx = g.pos[ii, 0] - g.pos[jj, 0]
    dy = g.pos[ii, 1] - g.pos[jj, 1]

    K1x = g.alpha * (g.x_bar[ii] - g.x_bar[jj]
                     - dx * g.w1_bar[ii] - dy * g.w2_bar[ii])
    K2x = g.beta * (g.w1_bar[ii] - g.w1_bar[jj])
    K3x = g.beta * (g.w2_bar[ii] - g.w2_bar[jj])

    q1 = _prox_nltgv2_conj(g.q1 + p.step_q * K1x)
    q2 = _prox_nltgv2_conj(g.q2 + p.step_q * K2x)
    q3 = _prox_nltgv2_conj(g.q3 + p.step_q * K3x)

    m = g.edge_mask
    return g._replace(q1=jnp.where(m, q1, 0.0),
                      q2=jnp.where(m, q2, 0.0),
                      q3=jnp.where(m, q3, 0.0))


def _primal_edge_terms(p: RegularizerParams, g: GraphState):
    """Per-edge primal-descent deltas (reference .cc:116-142)."""
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    dx = g.pos[ii, 0] - g.pos[jj, 0]
    dy = g.pos[ii, 1] - g.pos[jj, 1]
    sxa = p.step_x * g.alpha
    sxb = p.step_x * g.beta
    # Contributions: (to source vertex ii, to target vertex jj).
    d_x_i = -g.q1 * sxa
    d_x_j = g.q1 * sxa
    d_w1_i = g.q1 * sxa * dx - g.q2 * sxb
    d_w1_j = g.q2 * sxb
    d_w2_i = g.q1 * sxa * dy - g.q3 * sxb
    d_w2_j = g.q3 * sxb
    return ii, jj, d_x_i, d_x_j, d_w1_i, d_w1_j, d_w2_i, d_w2_j


def _primal_step_segment(p: RegularizerParams, g: GraphState) -> GraphState:
    """Primal descent via segment-sum scatter (reference semantics)."""
    V = g.x.shape[0]
    ii, jj, d_x_i, d_x_j, d_w1_i, d_w1_j, d_w2_i, d_w2_j = \
        _primal_edge_terms(p, g)

    seg = functools.partial(jax.ops.segment_sum, num_segments=V)
    x = g.x + seg(d_x_i, ii) + seg(d_x_j, jj)
    w1 = g.w1 + seg(d_w1_i, ii) + seg(d_w1_j, jj)
    w2 = g.w2 + seg(d_w2_i, ii) + seg(d_w2_j, jj)

    x = _prox_l1(p.x_min, p.x_max, p.step_x,
                 p.data_factor * g.data_weight, x, g.data_term)
    m = g.vtx_mask
    return g._replace(x=jnp.where(m, x, g.x),
                      w1=jnp.where(m, w1, g.w1),
                      w2=jnp.where(m, w2, g.w2))


def _primal_step_incidence(p: RegularizerParams, g: GraphState) -> GraphState:
    """Primal descent via the [V, D] incidence gather (fast path).

    For vertex v and incident edge e with sign s (+1 if v is the edge's
    source, -1 if target):
      x  += -s * q1 * step_x * alpha
      w1 += (s>0) * q1 * step_x * alpha * dx - s * q2 * step_x * beta
      w2 += (s>0) * q1 * step_x * alpha * dy - s * q3 * step_x * beta
    which reproduces the reference's source/target asymmetry exactly.
    """
    e = g.inc_edge  # (V, D)
    s = g.inc_sign  # (V, D)
    is_src = s > 0

    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    dx_e = g.pos[ii, 0] - g.pos[jj, 0]  # (E,)
    dy_e = g.pos[ii, 1] - g.pos[jj, 1]

    q1 = g.q1[e]
    q2 = g.q2[e]
    q3 = g.q3[e]
    sxa = p.step_x * g.alpha[e]
    sxb = p.step_x * g.beta[e]
    dx = dx_e[e]
    dy = dy_e[e]

    d_x = -s * q1 * sxa
    d_w1 = jnp.where(is_src, q1 * sxa * dx, 0.0) - s * q2 * sxb
    d_w2 = jnp.where(is_src, q1 * sxa * dy, 0.0) - s * q3 * sxb

    x = g.x + d_x.sum(axis=1)
    w1 = g.w1 + d_w1.sum(axis=1)
    w2 = g.w2 + d_w2.sum(axis=1)

    x = _prox_l1(p.x_min, p.x_max, p.step_x,
                 p.data_factor * g.data_weight, x, g.data_term)
    m = g.vtx_mask
    return g._replace(x=jnp.where(m, x, g.x),
                      w1=jnp.where(m, w1, g.w1),
                      w2=jnp.where(m, w2, g.w2))


def _extragradient_step(p: RegularizerParams, g: GraphState,
                        x_prev, w1_prev, w2_prev) -> GraphState:
    """Theta-overrelaxation; x_bar clamped to the feasible set, w bars not
    (reference .cc:156-174)."""
    x_bar = jnp.clip(g.x + p.theta * (g.x - x_prev), p.x_min, p.x_max)
    w1_bar = g.w1 + p.theta * (g.w1 - w1_prev)
    w2_bar = g.w2 + p.theta * (g.w2 - w2_prev)
    return g._replace(x_bar=x_bar, w1_bar=w1_bar, w2_bar=w2_bar)


def step(p: RegularizerParams, g: GraphState,
         use_incidence: bool = False) -> GraphState:
    """One full Chambolle-Pock iteration (reference .cc:33-49)."""
    x_prev, w1_prev, w2_prev = g.x, g.w1, g.w2
    g = _dual_step(p, g)
    if use_incidence:
        g = _primal_step_incidence(p, g)
    else:
        g = _primal_step_segment(p, g)
    return _extragradient_step(p, g, x_prev, w1_prev, w2_prev)


def _smooth_stacked(p: RegularizerParams, g: GraphState,
                    n_iters: int) -> GraphState:
    """K iterations with the per-edge vertex reads STACKED into one (V, 8)
    matrix so each iteration does exactly two row gathers and two row
    segment-sums.

    A 1-D gather/scatter costs about as much as an 8-column row gather
    (the cost is per index), so the naive field-per-field formulation
    (~15 gathers/iter) does far more work than this one. Edge geometry (dx, dy, alpha) is loop-invariant and hoisted.
    """
    V = g.x.shape[0]
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]

    # Loop-invariant per-edge quantities.
    dx = g.pos[ii, 0] - g.pos[jj, 0]
    dy = g.pos[ii, 1] - g.pos[jj, 1]
    alpha = jnp.where(g.edge_mask, g.alpha, 0.0)
    beta = jnp.where(g.edge_mask, g.beta, 0.0)
    sxa = p.step_x * alpha
    sxb = p.step_x * beta
    qa = p.step_q * alpha
    qb = p.step_q * beta
    vmask = g.vtx_mask
    weight = p.data_factor * g.data_weight
    zcol = jnp.zeros((V,), jnp.float32)

    def pack(x_bar, w1_bar, w2_bar):
        return jnp.stack(
            [x_bar, w1_bar, w2_bar, zcol, zcol, zcol, zcol, zcol], axis=1)

    def body(_, state):
        x, w1, w2, VB, q1, q2, q3 = state
        x_prev, w1_prev, w2_prev = x, w1, w2

        gi = VB[ii]  # (E, 8)
        gj = VB[jj]

        # Dual ascent (reference .cc:89-114).
        K1 = (gi[:, 0] - gj[:, 0]) - dx * gi[:, 1] - dy * gi[:, 2]
        nq1 = _prox_nltgv2_conj(q1 + qa * K1)
        nq2 = _prox_nltgv2_conj(q2 + qb * (gi[:, 1] - gj[:, 1]))
        nq3 = _prox_nltgv2_conj(q3 + qb * (gi[:, 2] - gj[:, 2]))

        # Primal descent contributions (reference .cc:116-142).
        Ci = jnp.stack([-nq1 * sxa,
                        nq1 * sxa * dx - nq2 * sxb,
                        nq1 * sxa * dy - nq3 * sxb], axis=1)  # (E, 3)
        Cj = jnp.stack([nq1 * sxa, nq2 * sxb, nq3 * sxb], axis=1)

        Si = jax.ops.segment_sum(Ci, ii, num_segments=V)  # (V, 3)
        Sj = jax.ops.segment_sum(Cj, jj, num_segments=V)

        nx = x + Si[:, 0] + Sj[:, 0]
        nw1 = w1 + Si[:, 1] + Sj[:, 1]
        nw2 = w2 + Si[:, 2] + Sj[:, 2]

        nx = _prox_l1(p.x_min, p.x_max, p.step_x, weight, nx, g.data_term)
        nx = jnp.where(vmask, nx, x)
        nw1 = jnp.where(vmask, nw1, w1)
        nw2 = jnp.where(vmask, nw2, w2)

        # Extragradient (reference .cc:156-174).
        x_bar = jnp.clip(nx + p.theta * (nx - x_prev), p.x_min, p.x_max)
        w1_bar = nw1 + p.theta * (nw1 - w1_prev)
        w2_bar = nw2 + p.theta * (nw2 - w2_prev)

        return (nx, nw1, nw2, pack(x_bar, w1_bar, w2_bar), nq1, nq2, nq3)

    init = (g.x, g.w1, g.w2, pack(g.x_bar, g.w1_bar, g.w2_bar),
            g.q1, g.q2, g.q3)
    x, w1, w2, VB, q1, q2, q3 = jax.lax.fori_loop(0, n_iters, body, init)
    em = g.edge_mask
    return g._replace(x=x, w1=w1, w2=w2,
                      x_bar=VB[:, 0], w1_bar=VB[:, 1], w2_bar=VB[:, 2],
                      q1=jnp.where(em, q1, 0.0),
                      q2=jnp.where(em, q2, 0.0),
                      q3=jnp.where(em, q3, 0.0))


def _smooth_vertex_centric(p: RegularizerParams, g: GraphState,
                           n_iters: int) -> GraphState:
    """K iterations with ONE (V, D) neighbor row-gather per iteration.

    Fully vertex-centric: every vertex holds a local copy of each incident
    edge's dual (q1, q2, q3) in its [V, D] incidence slots and updates it
    locally each iteration. Both endpoints of an edge compute the update
    from identical operands in identical order, so the two copies stay
    bit-identical — no scatter, no second gather. This formulation
    gathers V*D rows/iter vs 2E + V*D for incidence-primal or
    2x(E row-gather + E-row scatter) for the stacked loop — and scatters
    cost more than gathers.

    Requires g.inc_edge / g.inc_sign / g.src_slot (from
    topology.from_edges/from_triangles with build_incidence=True). Duals
    enter by replication q_edge[inc_edge] and exit by gathering each
    edge's src-slot copy — the canonical per-edge arrays stay the durable
    representation for carry-over across retriangulations.
    """
    V = g.x.shape[0]
    D = g.inc_edge.shape[1]
    e = g.inc_edge  # (V, D)
    has = g.inc_sign != 0.0
    is_src = g.inc_sign > 0.0

    # Loop-invariant per-slot edge state, in canonical orientation. All
    # per-edge quantities ride ONE (E, 8) row gather instead of one
    # field-by-field (V, D) gather per (E,) array.
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    dx_e = g.pos[ii, 0] - g.pos[jj, 0]
    dy_e = g.pos[ii, 1] - g.pos[jj, 1]
    alpha_e = jnp.where(g.edge_mask, g.alpha, 0.0)
    beta_e = jnp.where(g.edge_mask, g.beta, 0.0)
    EM = jnp.stack([dx_e, dy_e, alpha_e, beta_e, g.q1, g.q2, g.q3,
                    jnp.zeros_like(dx_e)], axis=1)  # (E, 8)
    S = EM[e]  # (V, D, 8)
    hasf = has.astype(jnp.float32)
    sdx = S[..., 0]
    sdy = S[..., 1]
    sal = S[..., 2] * hasf
    sbe = S[..., 3] * hasf
    q1 = S[..., 4] * hasf
    q2 = S[..., 5] * hasf
    q3 = S[..., 6] * hasf

    # Neighbor index: the other endpoint of the slot's edge (self is always
    # one of the two for real slots; pad slots are masked and clipped).
    esum = (ii + jj)[e]  # one small int gather
    nbr = jnp.clip(esum - jnp.arange(V, dtype=jnp.int32)[:, None], 0, V - 1)

    sxa = p.step_x * sal
    sxb = p.step_x * sbe
    qa = p.step_q * sal
    qb = p.step_q * sbe
    sgn = jnp.where(is_src, 1.0, -1.0) * hasf
    srcf = is_src.astype(jnp.float32)

    vmask = g.vtx_mask
    weight = p.data_factor * g.data_weight
    zcol = jnp.zeros((V,), jnp.float32)

    def pack(xb, w1b, w2b):
        return jnp.stack(
            [xb, w1b, w2b, zcol, zcol, zcol, zcol, zcol], axis=1)

    def body(_, state):
        x, w1, w2, VB, q1, q2, q3 = state
        x_prev, w1_prev, w2_prev = x, w1, w2

        nb = VB[nbr]  # (V, D, 8) — the one gather
        xb_n, w1b_n, w2b_n = nb[..., 0], nb[..., 1], nb[..., 2]
        xb_s = VB[:, None, 0]
        w1b_s = VB[:, None, 1]
        w2b_s = VB[:, None, 2]

        # Edge fields in canonical (src i, dst j) orientation.
        xb_i = jnp.where(is_src, xb_s, xb_n)
        xb_j = jnp.where(is_src, xb_n, xb_s)
        w1b_i = jnp.where(is_src, w1b_s, w1b_n)
        w1b_j = jnp.where(is_src, w1b_n, w1b_s)
        w2b_i = jnp.where(is_src, w2b_s, w2b_n)
        w2b_j = jnp.where(is_src, w2b_n, w2b_s)

        # Dual ascent (reference .cc:89-114), per slot.
        K1 = (xb_i - xb_j) - sdx * w1b_i - sdy * w2b_i
        nq1 = _prox_nltgv2_conj(q1 + qa * K1)
        nq2 = _prox_nltgv2_conj(q2 + qb * (w1b_i - w1b_j))
        nq3 = _prox_nltgv2_conj(q3 + qb * (w2b_i - w2b_j))

        # Primal descent: each slot contributes to its own vertex
        # (reference .cc:116-142 source/target asymmetry via sgn/srcf).
        d_x = -sgn * nq1 * sxa
        d_w1 = srcf * nq1 * sxa * sdx - sgn * nq2 * sxb
        d_w2 = srcf * nq1 * sxa * sdy - sgn * nq3 * sxb

        nx = x + d_x.sum(1)
        nw1 = w1 + d_w1.sum(1)
        nw2 = w2 + d_w2.sum(1)

        nx = _prox_l1(p.x_min, p.x_max, p.step_x, weight, nx, g.data_term)
        nx = jnp.where(vmask, nx, x)
        nw1 = jnp.where(vmask, nw1, w1)
        nw2 = jnp.where(vmask, nw2, w2)

        # Extragradient (reference .cc:156-174).
        xb = jnp.clip(nx + p.theta * (nx - x_prev), p.x_min, p.x_max)
        w1b = nw1 + p.theta * (nw1 - w1_prev)
        w2b = nw2 + p.theta * (nw2 - w2_prev)
        return (nx, nw1, nw2, pack(xb, w1b, w2b), nq1, nq2, nq3)

    init = (g.x, g.w1, g.w2, pack(g.x_bar, g.w1_bar, g.w2_bar), q1, q2, q3)
    x, w1, w2, VB, q1, q2, q3 = jax.lax.fori_loop(0, n_iters, body, init)

    # Write the duals back to the canonical per-edge arrays via each edge's
    # src slot (dst fallback). A valid edge whose BOTH incidence entries
    # were dropped by degree overflow holds the sentinel slot V*D; its
    # duals were not iterated this call, so its CARRIED values pass
    # through untouched (the pallas path preserves them the same way —
    # zeroing would destroy the dual warm-start across frames).
    V = x.shape[0]
    D = g.inc_edge.shape[1]
    slotted = g.src_slot < V * D
    def unslot(q, prev):
        vals = jnp.pad(q.reshape(-1), (0, 1))[g.src_slot]
        return jnp.where(slotted, vals, prev)
    em = g.edge_mask
    return g._replace(x=x, w1=w1, w2=w2,
                      x_bar=VB[:, 0], w1_bar=VB[:, 1], w2_bar=VB[:, 2],
                      q1=jnp.where(em, unslot(q1, g.q1), 0.0),
                      q2=jnp.where(em, unslot(q2, g.q2), 0.0),
                      q3=jnp.where(em, unslot(q3, g.q3), 0.0))


@functools.partial(jax.jit, static_argnames=("p", "n_iters", "use_incidence",
                                             "stacked", "mode"))
def smooth(p: RegularizerParams, g: GraphState, n_iters: int,
           use_incidence: bool = False, stacked: bool = True,
           mode: str = None) -> GraphState:
    """Run n_iters iterations fused into one XLA computation.

    mode selects the formulation (all numerically equivalent):
      * "vertex": one (V, D) neighbor gather/iter — the production path;
        requires incidence tables + src_slot on the graph.
      * "stacked": two row gathers + two segment-sums/iter.
      * "step": the field-per-field reference semantics (tests, sharding).
    Legacy flags: stacked=True -> "stacked" (default), use_incidence ->
    per-step incidence primal.
    """
    if mode is None:
        mode = "stacked" if stacked else "step"
    if mode == "vertex":
        return _smooth_vertex_centric(p, g, n_iters)
    if mode == "stacked":
        return _smooth_stacked(p, g, n_iters)

    def body(_, gg):
        return step(p, gg, use_incidence=use_incidence)
    return jax.lax.fori_loop(0, n_iters, body, g)


# ---------------------------------------------------------------------------
# Cost diagnostics (reference .cc:51-85).
# ---------------------------------------------------------------------------


def smoothness_cost(p: RegularizerParams, g: GraphState) -> jax.Array:
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    dx = g.pos[ii, 0] - g.pos[jj, 0]
    dy = g.pos[ii, 1] - g.pos[jj, 1]
    c = (g.alpha * jnp.abs(g.x[ii] - g.x[jj]
                           - g.w1[ii] * dx - g.w2[ii] * dy)
         + g.beta * jnp.abs(g.w1[ii] - g.w1[jj])
         + g.beta * jnp.abs(g.w2[ii] - g.w2[jj]))
    return p.data_factor * jnp.sum(jnp.where(g.edge_mask, c, 0.0))


def data_cost(p: RegularizerParams, g: GraphState) -> jax.Array:
    c = jnp.abs((g.x - g.data_term) * g.data_weight)
    return jnp.sum(jnp.where(g.vtx_mask, c, 0.0))


def total_cost(p: RegularizerParams, g: GraphState) -> jax.Array:
    """Reference-parity diagnostic: data_factor * raw_smoothness + raw_data
    (the quantity the reference logs, flame.cc:2172-2177). NOTE this is NOT
    the minimized functional — see energy()."""
    return smoothness_cost(p, g) + data_cost(p, g)


def energy(p: RegularizerParams, g: GraphState) -> jax.Array:
    """The functional the Chambolle-Pock iteration actually minimizes:
    raw NLTGV2 smoothness + data_factor * weighted-L1 data term (the proxL1
    threshold is step_x * data_factor * weight, reference .cc:149-150, so
    data_factor multiplies the data term, not the smoothness)."""
    return smoothness_cost(p, g) / p.data_factor + p.data_factor * data_cost(p, g)
