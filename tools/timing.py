"""Shared helpers of the experiment tools: a realistic VGA smoothing
graph and a wall-clock timer."""

import time

import numpy as np
import jax.numpy as jnp


def timeit(fn, reps=5, inner=1):
    """Best wall seconds of fn() over reps runs after one warm-up run,
    divided by inner. fn() must end in jax.block_until_ready or a host
    read, so the time covers the device work."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best / inner


def make_graph(V=4096, E=16384, n_used=2700, seed=0):
    """Realistic graph: Delaunay over random VGA points."""
    from scipy.spatial import Delaunay as SDelaunay
    from flame_tpu.optimize import nltgv2

    rng = np.random.default_rng(seed)
    pts = rng.uniform([8, 8], [632, 472], size=(n_used, 2)).astype(np.float32)
    sd = SDelaunay(pts)
    tris = sd.simplices
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.sort(e, axis=1)
    e = np.unique(e[:, 0].astype(np.int64) * V + e[:, 1])
    e = np.stack([e // V, e % V], axis=1)
    n_e = e.shape[0]
    assert n_e <= E, (n_e, E)

    edges = np.zeros((E, 2), np.int64)
    edges[:n_e] = e
    emask = np.zeros(E, bool)
    emask[:n_e] = True
    vmask = np.zeros(V, bool)
    vmask[:n_used] = True

    g = nltgv2.empty(V, E, 16)
    pos = np.zeros((V, 2), np.float32)
    pos[:n_used] = pts
    d = pos[edges[:, 0]] - pos[edges[:, 1]]
    ln = np.sqrt((d * d).sum(1))
    alpha = np.where(emask & (ln > 1e-6), 1.0 / np.maximum(ln, 1e-6), 0.0)
    x = rng.uniform(0.15, 0.25, V).astype(np.float32) * vmask
    g = g._replace(
        pos=jnp.asarray(pos), x=jnp.asarray(x), x_bar=jnp.asarray(x),
        data_term=jnp.asarray(x + rng.normal(0, 0.01, V).astype(np.float32)
                              * vmask),
        data_weight=jnp.asarray(vmask.astype(np.float32)),
        vtx_mask=jnp.asarray(vmask),
        edges=jnp.asarray(edges.astype(np.int32)),
        alpha=jnp.asarray(alpha.astype(np.float32)),
        beta=jnp.asarray(emask.astype(np.float32)),
        edge_mask=jnp.asarray(emask))
    return g, e, n_e, tris, n_used
