"""Device-side graph topology: edges, dual carry-over, incidence tables —
all derived from the (host-uploaded) triangle list.

The reference rebuilds its Boost edge set with hash-map surgery on the
host every frame (flame.cc:2075-2121); the first flame_tpu version did the
same in numpy and uploaded ~1 MB of edge/incidence arrays per frame.
Here the host uploads ONLY the
triangle array (int16 slot indices) and the device derives:

  * the unique undirected edge set, canonicalized (lo, hi) and stored in
    sorted-code order (sort + adjacent-unique + scatter-by-rank),
  * dual-variable carry-over for edges whose vertex pair survived the
    retriangulation (binary search of new codes in the previous frame's
    sorted codes — reference flame.cc:2094-2104 semantics),
  * per-edge alpha = 1/length from current vertex positions, and
  * the [V, D] incidence table for the gather-based primal step.

Everything is fixed-shape and fuses into the per-frame post-Delaunay jit.
"""

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


# Edge-length floor (pixels) for alpha = 1/length (reference
# flame.cc:2102 computes it unclamped from a FRESH per-frame
# triangulation). Under lagged topology two tracked features can drift
# onto (nearly) the same pixel, sending 1/length to 1e4+ — which breaks
# the Chambolle-Pock step-size condition tau*sigma*||K||^2 <= 1 for the
# default steps (tuned for mesh edges >= a few pixels) and blows up the
# incident vertices. Below one pixel, 1/length carries no geometric
# information anyway (positions are quantized at 1/32 px in the packed
# snapshot), so alpha saturates at the 1-px value.
MIN_EDGE_LENGTH = 1.0


class Topology(NamedTuple):
    edges: jax.Array  # (E, 2) int32 canonical (lo, hi), sorted by code
    alpha: jax.Array  # (E,) 1/length, 0 when invalid
    edge_mask: jax.Array  # (E,) bool
    q1: jax.Array  # (E,) carried duals (0 for new edges)
    q2: jax.Array
    q3: jax.Array
    inc_edge: jax.Array  # (V, D) int32
    inc_sign: jax.Array  # (V, D) float32
    n_edges: jax.Array  # () int32
    src_slot: jax.Array = None  # (E,) int32 flat (V*D) slot of each edge's
    # entry in the incidence table (src endpoint preferred, dst fallback,
    # V*D sentinel when dropped) — lets the vertex-centric smoother write
    # its per-slot duals back to the canonical per-edge arrays.


def _edge_codes(edges, edge_mask, v_cap):
    big = jnp.int32(v_cap * v_cap)
    code = edges[:, 0] * v_cap + edges[:, 1]
    return jnp.where(edge_mask, code, big)


def _build_incidence_device(lo_e, hi_e, edge_mask, e_cap, v_cap, degree):
    """Device-side [V, D] incidence tables + per-edge src_slot.

    Sorts the 2E (vertex, edge, sign) triples by vertex, ranks within each
    vertex group, scatters ranks < degree. src_slot maps edge -> flat slot
    (vertex*degree + rank) of its source-endpoint entry (dst entry as a
    fallback, V*D sentinel when both dropped).
    """
    verts = jnp.concatenate([lo_e, hi_e])
    eids = jnp.tile(jnp.arange(e_cap, dtype=jnp.int32), 2)
    signs = jnp.concatenate([jnp.ones(e_cap, jnp.float32),
                             -jnp.ones(e_cap, jnp.float32)])
    vkey = jnp.where(jnp.concatenate([edge_mask, edge_mask]), verts,
                     jnp.int32(v_cap))
    order = jnp.argsort(vkey)
    vs = vkey[order]
    firstv = jnp.searchsorted(vs, vs)
    rankv = jnp.arange(2 * e_cap) - firstv
    eo = eids[order]
    so = signs[order]
    # Degree overflow drops the edge on BOTH sides (consistent with
    # _build_incidence_from_ranks/perm_edge_ranks): a one-sidedly kept
    # entry would apply the edge's primal force to one endpoint only,
    # breaking K/K^T adjointness at hub vertices.
    entry_ok = (rankv < degree) & (vs < v_cap)
    ok_src = jnp.zeros((e_cap + 1,), bool).at[
        jnp.where(so > 0, eo, e_cap)].set(entry_ok, mode="drop")[:e_cap]
    ok_dst = jnp.zeros((e_cap + 1,), bool).at[
        jnp.where(so < 0, eo, e_cap)].set(entry_ok, mode="drop")[:e_cap]
    both_ok = ok_src & ok_dst
    keep = entry_ok & both_ok[eo]
    islot = jnp.where(keep, vs * degree + rankv, v_cap * degree)
    inc_edge = jnp.zeros((v_cap * degree + 1,), jnp.int32)
    inc_edge = inc_edge.at[islot].set(eo, mode="drop")
    inc_sign = jnp.zeros((v_cap * degree + 1,), jnp.float32)
    inc_sign = inc_sign.at[islot].set(so, mode="drop")

    sentinel = jnp.int32(v_cap * degree)
    src_slot = jnp.full((e_cap + 1,), sentinel, jnp.int32)
    # dst entries first, src entries override (each edge has at most one of
    # each, so each scatter's indices are unique).
    dst_i = jnp.where(keep & (so < 0), eo, e_cap)
    src_slot = src_slot.at[dst_i].set(islot.astype(jnp.int32), mode="drop")
    src_i = jnp.where(keep & (so > 0), eo, e_cap)
    src_slot = src_slot.at[src_i].set(islot.astype(jnp.int32), mode="drop")

    return (inc_edge[:-1].reshape(v_cap, degree),
            inc_sign[:-1].reshape(v_cap, degree),
            src_slot[:e_cap])


def _build_incidence_from_ranks(lo_e, hi_e, edge_mask, ranks, e_cap, v_cap,
                                degree):
    """Scatter-only incidence build from host-computed slot ranks.

    ranks: (E, 2) uint8 — [src_rank, dst_slot_rank] per edge, where
    src_rank is the edge's rank among its lo-vertex's outgoing edges and
    dst_slot_rank = n_src(hi) + rank among hi's incoming edges (so src and
    dst entries occupy disjoint slot ranges per vertex). Replaces the
    device-side 2E-key argsort with two scatters.
    """
    sr = ranks[:, 0].astype(jnp.int32)
    dr = ranks[:, 1].astype(jnp.int32)
    # Degree overflow drops the edge on BOTH sides (consistent with
    # pallas_smoother.perm_edge_ranks): a one-sidedly kept slot would
    # apply the edge's primal force to one endpoint only, breaking
    # K/K^T adjointness at hub vertices.
    keep = edge_mask & (sr < degree) & (dr < degree)
    keep_s = keep
    keep_d = keep
    sentinel = jnp.int32(v_cap * degree)
    slot_s = jnp.where(keep_s, lo_e * degree + sr, sentinel)
    slot_d = jnp.where(keep_d, hi_e * degree + dr, sentinel)
    eids = jnp.arange(e_cap, dtype=jnp.int32)

    inc_edge = jnp.zeros((v_cap * degree + 1,), jnp.int32)
    inc_edge = inc_edge.at[slot_s].set(eids, mode="drop")
    inc_edge = inc_edge.at[slot_d].set(eids, mode="drop")
    inc_sign = jnp.zeros((v_cap * degree + 1,), jnp.float32)
    inc_sign = inc_sign.at[slot_s].set(
        jnp.where(keep_s, 1.0, 0.0), mode="drop")
    inc_sign = inc_sign.at[slot_d].set(
        jnp.where(keep_d, -1.0, 0.0), mode="drop")

    src_slot = jnp.where(keep_s, slot_s,
                         jnp.where(keep_d, slot_d, sentinel))
    return (inc_edge[:-1].reshape(v_cap, degree),
            inc_sign[:-1].reshape(v_cap, degree),
            src_slot)


def rank_within(keys: np.ndarray, tie=None) -> np.ndarray:
    """Rank of each element among equal `keys` values. With `tie`,
    elements of a key group are ranked by ascending tie value (used to
    give a vertex's LONGEST edges the highest slot ranks, so capacity
    overflow drops the weakest alpha=1/len couplings first)."""
    n = keys.shape[0]
    order = (np.argsort(keys, kind="stable") if tie is None
             else np.lexsort((tie, keys)))
    ks = keys[order]
    first = np.searchsorted(ks, ks, side="left")
    r = np.empty(n, np.int64)
    r[order] = np.arange(n) - first
    return r


def build_edge_ranks(edges_sorted: np.ndarray, n_vertices: int,
                     e_cap: int, tie=None) -> np.ndarray:
    """Host-side companion to _build_incidence_from_ranks.

    edges_sorted: (n_e, 2) canonical (lo, hi) sorted by lo*V+hi. Returns
    (e_cap, 2) uint8 [src_rank, dst_slot_rank] (255-saturated), padded.
    tie: optional per-edge sort key (e.g. length) ordering each vertex's
    incident edges within its slot block; see rank_within.
    """
    _np = np
    n_e = edges_sorted.shape[0]
    ranks = _np.zeros((e_cap, 2), _np.uint8)
    if n_e == 0:
        return ranks
    lo = edges_sorted[:, 0].astype(_np.int64)
    hi = edges_sorted[:, 1].astype(_np.int64)
    src_rank = rank_within(lo, tie)
    n_src = _np.bincount(lo, minlength=n_vertices)
    dst_slot_rank = n_src[hi] + rank_within(hi, tie)
    ranks[:n_e, 0] = _np.minimum(src_rank, 255)
    ranks[:n_e, 1] = _np.minimum(dst_slot_rank, 255)
    return ranks


@functools.partial(jax.jit, static_argnames=("e_cap", "v_cap", "degree",
                                             "build_incidence"))
def from_edges(edges_in, n_edges, pos, prev_edges, prev_edge_mask,
               prev_q1, prev_q2, prev_q3,
               e_cap: int, v_cap: int, degree: int,
               build_incidence: bool = False, ranks=None,
               carry_idx=None, carry_fresh=None) -> Topology:
    """Like from_triangles, but the host supplies the unique edge list
    directly (canonical (lo, hi), sorted by lo*V+hi code, padded to E) —
    the host already has it from Delaunay, so the device-side
    3T-key sort/unique is unnecessary. Only carry-over, alpha, and the
    optional incidence remain on device. When the host also supplies slot
    ranks (build_edge_ranks), the incidence build is scatter-only.

    carry_idx: optional (E,) host-computed dual carry (index into the
    PREVIOUSLY APPLIED edge arrays, >= e_cap when the pair is new) —
    replaces a device-side binary search.
    carry_fresh: () bool — True only on the first application of a
    topology; on re-application the graph's dual arrays are already
    aligned with these edges and pass through unchanged.
    """
    edges = edges_in.astype(jnp.int32)
    edge_mask = jnp.arange(e_cap) < n_edges
    lo_e = jnp.where(edge_mask, edges[:, 0], 0)
    hi_e = jnp.where(edge_mask, edges[:, 1], 0)
    edges = jnp.stack([lo_e, hi_e], axis=1)

    d = pos[lo_e] - pos[hi_e]
    length = jnp.sqrt(jnp.sum(d * d, axis=1))
    alpha = jnp.where(edge_mask & (length > 1e-6),
                      1.0 / jnp.maximum(length, MIN_EDGE_LENGTH), 0.0)

    if carry_idx is not None:
        ci = jnp.minimum(carry_idx.astype(jnp.int32), e_cap - 1)
        okc = (carry_idx < e_cap) & edge_mask
        fresh = jnp.asarray(
            True if carry_fresh is None else carry_fresh, bool)

        def carry(prev_q):
            return jnp.where(
                fresh, jnp.where(okc, prev_q[ci], 0.0),
                jnp.where(edge_mask, prev_q, 0.0))

        q1, q2, q3 = carry(prev_q1), carry(prev_q2), carry(prev_q3)
    else:
        big = jnp.int32(v_cap * v_cap)
        edge_codes = jnp.where(edge_mask, lo_e * v_cap + hi_e, big)
        prev_codes = _edge_codes(prev_edges, prev_edge_mask, v_cap)
        posn = jnp.searchsorted(prev_codes, edge_codes)
        posn_c = jnp.minimum(posn, e_cap - 1)
        match = (prev_codes[posn_c] == edge_codes) & edge_mask
        q1 = jnp.where(match, prev_q1[posn_c], 0.0)
        q2 = jnp.where(match, prev_q2[posn_c], 0.0)
        q3 = jnp.where(match, prev_q3[posn_c], 0.0)

    if build_incidence and ranks is not None:
        inc_edge, inc_sign, src_slot = _build_incidence_from_ranks(
            lo_e, hi_e, edge_mask, ranks, e_cap, v_cap, degree)
    elif build_incidence:
        inc_edge, inc_sign, src_slot = _build_incidence_device(
            lo_e, hi_e, edge_mask, e_cap, v_cap, degree)
    else:
        inc_edge = jnp.zeros((v_cap, degree), jnp.int32)
        inc_sign = jnp.zeros((v_cap, degree), jnp.float32)
        # Sentinel, NOT zero: slot 0 is a real (vertex 0, rank 0) slot;
        # a consumer that wrongly reads src_slot from an incidence-less
        # topology must pass duals through untouched, not alias them all
        # onto slot 0.
        src_slot = jnp.full((e_cap,), v_cap * degree, jnp.int32)

    return Topology(edges=edges, alpha=alpha, edge_mask=edge_mask,
                    q1=q1, q2=q2, q3=q3,
                    inc_edge=inc_edge, inc_sign=inc_sign,
                    n_edges=jnp.asarray(n_edges, jnp.int32),
                    src_slot=src_slot)


@functools.partial(jax.jit, static_argnames=("e_cap", "v_cap", "degree",
                                             "build_incidence"))
def from_triangles(tris, n_tris, pos, prev_edges, prev_edge_mask,
                   prev_q1, prev_q2, prev_q3,
                   e_cap: int, v_cap: int, degree: int,
                   build_incidence: bool = True) -> Topology:
    """Build the edge topology from a padded triangle array.

    tris: (T, 3) integer vertex slots (any int dtype); n_tris: () count;
    pos: (V, 2) current vertex positions; prev_*: previous frame's edge
    arrays (in the sorted-code order this function produces).

    build_incidence=False skips the [V, D] incidence tables (a 2E-key
    argsort + scatters) — the production smoother (stacked segment-sum
    formulation) never reads them.
    """
    T = tris.shape[0]
    tris = tris.astype(jnp.int32)
    tri_mask = jnp.arange(T) < n_tris
    big = jnp.int32(v_cap * v_cap)

    # Directed edges of every triangle -> canonical codes.
    a = jnp.concatenate([tris[:, 0], tris[:, 1], tris[:, 2]])
    b = jnp.concatenate([tris[:, 1], tris[:, 2], tris[:, 0]])
    lo = jnp.minimum(a, b)
    hi = jnp.maximum(a, b)
    m3 = jnp.concatenate([tri_mask, tri_mask, tri_mask])
    code = jnp.where(m3, lo * v_cap + hi, big)

    scode = jnp.sort(code)
    first = jnp.concatenate([jnp.array([True]), scode[1:] != scode[:-1]])
    first = first & (scode < big)
    rank = jnp.cumsum(first) - 1  # slot for each first occurrence
    n_edges = jnp.sum(first).astype(jnp.int32)

    # Scatter unique codes into (E,) slots; overflow and non-firsts drop.
    slot = jnp.where(first & (rank < e_cap), rank, e_cap)
    edge_codes = jnp.full((e_cap + 1,), big, jnp.int32)
    edge_codes = edge_codes.at[slot].set(scode, mode="drop")[:e_cap]

    edge_mask = edge_codes < big
    lo_e = jnp.where(edge_mask, edge_codes // v_cap, 0)
    hi_e = jnp.where(edge_mask, edge_codes % v_cap, 0)
    edges = jnp.stack([lo_e, hi_e], axis=1).astype(jnp.int32)

    # alpha = 1 / pixel length (reference flame.cc:2102).
    d = pos[lo_e] - pos[hi_e]
    length = jnp.sqrt(jnp.sum(d * d, axis=1))
    alpha = jnp.where(edge_mask & (length > 1e-6),
                      1.0 / jnp.maximum(length, MIN_EDGE_LENGTH), 0.0)

    # Dual carry-over: binary-search new codes in the previous sorted codes.
    prev_codes = _edge_codes(prev_edges, prev_edge_mask, v_cap)
    posn = jnp.searchsorted(prev_codes, edge_codes)
    posn_c = jnp.minimum(posn, e_cap - 1)
    match = (prev_codes[posn_c] == edge_codes) & edge_mask
    q1 = jnp.where(match, prev_q1[posn_c], 0.0)
    q2 = jnp.where(match, prev_q2[posn_c], 0.0)
    q3 = jnp.where(match, prev_q3[posn_c], 0.0)

    if build_incidence:
        inc_edge, inc_sign, src_slot = _build_incidence_device(
            lo_e, hi_e, edge_mask, e_cap, v_cap, degree)
    else:
        inc_edge = jnp.zeros((v_cap, degree), jnp.int32)
        inc_sign = jnp.zeros((v_cap, degree), jnp.float32)
        # Sentinel, NOT zero: slot 0 is a real (vertex 0, rank 0) slot;
        # a consumer that wrongly reads src_slot from an incidence-less
        # topology must pass duals through untouched, not alias them all
        # onto slot 0.
        src_slot = jnp.full((e_cap,), v_cap * degree, jnp.int32)

    return Topology(edges=edges, alpha=alpha, edge_mask=edge_mask,
                    q1=q1, q2=q2, q3=q3,
                    inc_edge=inc_edge, inc_sign=inc_sign,
                    n_edges=jnp.minimum(n_edges, e_cap),
                    src_slot=src_slot)
