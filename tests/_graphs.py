"""Shared test graph builders for the smoother tests."""

import numpy as np
import jax.numpy as jnp

from flame_tpu.mesh import delaunay
from flame_tpu.optimize import nltgv2
from flame_tpu.parallel import halo


def make_graph(v_cap, e_cap, degree, seed=0, n_pts=200, span=250.0):
    """Random Delaunay graph over n_pts points in [5, span]^2 scattered
    into a v_cap-slot GraphState, with random primal/dual state. Returns
    (g, edges_sorted, n_e, member)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(5, span, (n_pts, 2)).astype(np.float32)
    tri = delaunay.triangulate(pts)
    slots = rng.permutation(v_cap)[:n_pts].astype(np.int32)

    edges_slots = np.sort(slots[tri.edges], axis=1)
    order = np.argsort(edges_slots[:, 0].astype(np.int64) * v_cap
                       + edges_slots[:, 1])
    edges_sorted = edges_slots[order]
    n_e = edges_sorted.shape[0]

    g = nltgv2.empty(v_cap, e_cap, degree)
    pos = np.zeros((v_cap, 2), np.float32)
    pos[slots] = pts
    member = np.zeros(v_cap, bool)
    member[slots] = True

    edges_full = np.zeros((e_cap, 2), np.int64)
    edges_full[:n_e] = edges_sorted
    edge_mask = np.arange(e_cap) < n_e
    d = pos[edges_full[:, 0]] - pos[edges_full[:, 1]]
    length = np.sqrt((d * d).sum(1))
    alpha = np.where(edge_mask & (length > 1e-6),
                     1.0 / np.maximum(length, 1e-6), 0.0)

    g = g._replace(
        pos=jnp.asarray(pos),
        x=jnp.asarray(np.where(member, rng.uniform(0.5, 2.0, v_cap), 0.0),
                      jnp.float32),
        w1=jnp.asarray(np.where(member, rng.normal(0, 0.01, v_cap), 0.0),
                       jnp.float32),
        w2=jnp.asarray(np.where(member, rng.normal(0, 0.01, v_cap), 0.0),
                       jnp.float32),
        data_term=jnp.asarray(
            np.where(member, rng.uniform(0.5, 2.0, v_cap), 0.0),
            jnp.float32),
        data_weight=jnp.asarray(member.astype(np.float32)),
        vtx_mask=jnp.asarray(member),
        edges=jnp.asarray(edges_full, jnp.int32),
        alpha=jnp.asarray(alpha, jnp.float32),
        beta=jnp.asarray(np.where(edge_mask, 1.0, 0.0), jnp.float32),
        q1=jnp.asarray(np.where(edge_mask, rng.uniform(-0.5, 0.5, e_cap),
                                0.0), jnp.float32),
        q2=jnp.asarray(np.where(edge_mask, rng.uniform(-0.5, 0.5, e_cap),
                                0.0), jnp.float32),
        q3=jnp.asarray(np.where(edge_mask, rng.uniform(-0.5, 0.5, e_cap),
                                0.0), jnp.float32),
        edge_mask=jnp.asarray(edge_mask))
    g = g._replace(x_bar=g.x, w1_bar=g.w1, w2_bar=g.w2)
    return g, edges_sorted, n_e, member


def rank_inputs(edges_sorted, n_e, member, v_cap, e_cap, degree, reach):
    """The halo smoother's rank layout of a make_graph graph: (perm, inv,
    ranks) as numpy arrays."""
    perm = halo.rcm_order(edges_sorted, n_e, v_cap, member)
    inv = np.empty(v_cap, np.int32)
    inv[perm] = np.arange(v_cap, dtype=np.int32)
    ranks = halo.perm_edge_ranks(edges_sorted, n_e, inv, e_cap, degree,
                                 reach=reach)
    return perm, inv, ranks
