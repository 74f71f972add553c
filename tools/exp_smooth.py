#!/usr/bin/env python
"""Experiment: NLTGV2 smoother formulations on the live device.

Variants:
  A stacked        current production (2 row-gathers + 2 segment-sums)
  B concat         1 row-gather (2E) + 1 segment-sum (2E)
  C inc            1 row-gather (2E) + incidence row-gather (V*D) primal
  D concat-sorted  B with indices_are_sorted on the gather-side sum
"""

import os
import sys
import time
import functools

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import numpy as np
import jax
import jax.numpy as jnp

from flame_tpu.utils import compile_cache

compile_cache.enable()

from flame_tpu.params import RegularizerParams
from flame_tpu.optimize import nltgv2
from tools.timing import make_graph, timeit


def _prox_conj(q):
    return q / jnp.maximum(jnp.abs(q), 1.0)


def _prox_l1(p, weight, x, data):
    diff = x - data
    thresh = p.step_x * weight
    new_x = jnp.where(diff > thresh, x - thresh,
                      jnp.where(diff < -thresh, x + thresh, data))
    return jnp.clip(new_x, p.x_min, p.x_max)


def smooth_concat(p, g, n_iters, sorted_sum=False):
    """One (2E,8) gather + one (2E,3) segment_sum per iteration."""
    V = g.x.shape[0]
    E = g.q1.shape[0]
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    cat = jnp.concatenate([ii, jj])  # (2E,)

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

    def pack(xb, w1b, w2b):
        return jnp.stack([xb, w1b, w2b, zcol, zcol, zcol, zcol, zcol], axis=1)

    def body(_, state):
        x, w1, w2, VB, q1, q2, q3 = state
        x_prev, w1_prev, w2_prev = x, w1, w2

        gcat = VB[cat]  # (2E, 8)
        gi = gcat[:E]
        gj = gcat[E:]

        K1 = (gi[:, 0] - gj[:, 0]) - dx * gi[:, 1] - dy * gi[:, 2]
        nq1 = _prox_conj(q1 + qa * K1)
        nq2 = _prox_conj(q2 + qb * (gi[:, 1] - gj[:, 1]))
        nq3 = _prox_conj(q3 + qb * (gi[:, 2] - gj[:, 2]))

        Ci = jnp.stack([-nq1 * sxa,
                        nq1 * sxa * dx - nq2 * sxb,
                        nq1 * sxa * dy - nq3 * sxb], axis=1)
        Cj = jnp.stack([nq1 * sxa, nq2 * sxb, nq3 * sxb], axis=1)
        C = jnp.concatenate([Ci, Cj], axis=0)  # (2E, 3)

        S = jax.ops.segment_sum(C, cat, num_segments=V,
                                indices_are_sorted=sorted_sum)

        nx = x + S[:, 0]
        nw1 = w1 + S[:, 1]
        nw2 = w2 + S[:, 2]

        nx = _prox_l1(p, weight, nx, g.data_term)
        nx = jnp.where(vmask, nx, x)
        nw1 = jnp.where(vmask, nw1, w1)
        nw2 = jnp.where(vmask, nw2, w2)

        xb = jnp.clip(nx + p.theta * (nx - x_prev), p.x_min, p.x_max)
        w1b = nw1 + p.theta * (nw1 - w1_prev)
        w2b = nw2 + p.theta * (nw2 - w2_prev)
        return (nx, nw1, nw2, pack(xb, w1b, w2b), nq1, nq2, nq3)

    init = (g.x, g.w1, g.w2, pack(g.x_bar, g.w1_bar, g.w2_bar),
            g.q1, g.q2, g.q3)
    x, w1, w2, VB, q1, q2, q3 = jax.lax.fori_loop(0, n_iters, body, init)
    return g._replace(x=x, w1=w1, w2=w2, x_bar=VB[:, 0], w1_bar=VB[:, 1],
                      w2_bar=VB[:, 2], q1=q1, q2=q2, q3=q3)


def smooth_incidence(p, g, n_iters, inc_edge, inc_sign):
    """Gather-only: edge gather (2E,8) + incidence gather (V,D) rows of the
    (E,6) contribution matrix. No scatters at all."""
    V = g.x.shape[0]
    E = g.q1.shape[0]
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    cat = jnp.concatenate([ii, jj])

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
    is_src = (inc_sign > 0)[..., None]  # (V, D, 1)
    has = (inc_sign != 0)[..., None]

    def pack(xb, w1b, w2b):
        return jnp.stack([xb, w1b, w2b, zcol, zcol, zcol, zcol, zcol], axis=1)

    def body(_, state):
        x, w1, w2, VB, q1, q2, q3 = state
        x_prev, w1_prev, w2_prev = x, w1, w2

        gcat = VB[cat]
        gi = gcat[:E]
        gj = gcat[E:]

        K1 = (gi[:, 0] - gj[:, 0]) - dx * gi[:, 1] - dy * gi[:, 2]
        nq1 = _prox_conj(q1 + qa * K1)
        nq2 = _prox_conj(q2 + qb * (gi[:, 1] - gj[:, 1]))
        nq3 = _prox_conj(q3 + qb * (gi[:, 2] - gj[:, 2]))

        Ci = jnp.stack([-nq1 * sxa,
                        nq1 * sxa * dx - nq2 * sxb,
                        nq1 * sxa * dy - nq3 * sxb], axis=1)
        Cj = jnp.stack([nq1 * sxa, nq2 * sxb, nq3 * sxb], axis=1)
        C = jnp.concatenate([Ci, Cj], axis=1)  # (E, 6)

        Cg = C[inc_edge]  # (V, D, 6)
        contrib = jnp.where(has, jnp.where(is_src, Cg[..., :3], Cg[..., 3:]),
                            0.0)
        S = contrib.sum(axis=1)  # (V, 3)

        nx = x + S[:, 0]
        nw1 = w1 + S[:, 1]
        nw2 = w2 + S[:, 2]

        nx = _prox_l1(p, weight, nx, g.data_term)
        nx = jnp.where(vmask, nx, x)
        nw1 = jnp.where(vmask, nw1, w1)
        nw2 = jnp.where(vmask, nw2, w2)

        xb = jnp.clip(nx + p.theta * (nx - x_prev), p.x_min, p.x_max)
        w1b = nw1 + p.theta * (nw1 - w1_prev)
        w2b = nw2 + p.theta * (nw2 - w2_prev)
        return (nx, nw1, nw2, pack(xb, w1b, w2b), nq1, nq2, nq3)

    init = (g.x, g.w1, g.w2, pack(g.x_bar, g.w1_bar, g.w2_bar),
            g.q1, g.q2, g.q3)
    x, w1, w2, VB, q1, q2, q3 = jax.lax.fori_loop(0, n_iters, body, init)
    return g._replace(x=x, w1=w1, w2=w2, x_bar=VB[:, 0], w1_bar=VB[:, 1],
                      w2_bar=VB[:, 2], q1=q1, q2=q2, q3=q3)


def main():
    print(f"device: {jax.devices()[0]}")
    g, edges_np, n_e, tris_np, n_used = make_graph()
    p = RegularizerParams()
    N_IT = 40

    # Incidence tables (host-built).
    inc_edge, inc_sign = nltgv2.build_incidence(
        np.asarray(g.edges), np.asarray(g.edge_mask), g.x.shape[0], 16)
    inc_edge_d = jnp.asarray(inc_edge)
    inc_sign_d = jnp.asarray(inc_sign)

    ref = nltgv2.smooth(p, g, N_IT)
    ref_x = np.asarray(ref.x)

    fA = jax.jit(lambda g: nltgv2.smooth(p, g, N_IT))
    fB = jax.jit(lambda g: smooth_concat(p, g, N_IT))
    fD = jax.jit(lambda g: smooth_concat(p, g, N_IT, sorted_sum=True))
    fC = jax.jit(lambda g: smooth_incidence(p, g, N_IT, inc_edge_d,
                                            inc_sign_d))

    for name, f in [("A stacked", fA), ("B concat", fB),
                    ("D concat-sorted", fD), ("C incidence", fC)]:
        out = f(g)
        err = np.abs(np.asarray(out.x) - ref_x).max()
        def run(f=f):
            np.asarray(f(g).x[0])
        dt = timeit(run, inner=N_IT)
        print(f"{name:18s} {dt*1e3:7.3f} ms/iter  max|dx|={err:.2e}")


if __name__ == "__main__":
    main()


# ---------------------------------------------------------------------------
# Variant E: vertex-centric, ONE (V, D) neighbor row-gather per iteration.
# Each edge's dual update is computed twice (once at each endpoint) from
# identical operands, so both copies stay bit-identical; no scatter needed.
# ---------------------------------------------------------------------------


def build_vertex_tables(edges, edge_mask, pos, alpha, V, D):
    """Host build: per-(vertex, slot) tables.

    Returns nbr (V,D) int32, is_src (V,D) f32 (1/0), has (V,D) f32,
    sdx, sdy, salpha (V,D) — dx,dy as (pos[src]-pos[dst]) for the canonical
    edge orientation regardless of which endpoint owns the slot.
    """
    nbr = np.zeros((V, D), np.int32)
    is_src = np.zeros((V, D), np.float32)
    has = np.zeros((V, D), np.float32)
    sdx = np.zeros((V, D), np.float32)
    sdy = np.zeros((V, D), np.float32)
    sal = np.zeros((V, D), np.float32)
    fill = np.zeros(V, np.int32)
    eidx = np.nonzero(edge_mask)[0]
    for e in eidx:
        i, j = int(edges[e, 0]), int(edges[e, 1])
        dx = float(pos[i, 0] - pos[j, 0])
        dy = float(pos[i, 1] - pos[j, 1])
        al = float(alpha[e])
        for v, other, src in ((i, j, 1.0), (j, i, 0.0)):
            k = fill[v]
            if k < D:
                nbr[v, k] = other
                is_src[v, k] = src
                has[v, k] = 1.0
                sdx[v, k] = dx
                sdy[v, k] = dy
                sal[v, k] = al
                fill[v] += 1
    return nbr, is_src, has, sdx, sdy, sal


def smooth_vertex_centric(p, g, n_iters, nbr, is_src, has, sdx, sdy, sal,
                          q0, width=4):
    """q0: (V, D, 3) initial duals (edge duals replicated at both endpoint
    slots). Returns (x, w1, w2, x_bar..., q (V,D,3))."""
    V, D = nbr.shape
    vmask = g.vtx_mask
    weight = p.data_factor * g.data_weight
    sxa = p.step_x * sal * has      # (V, D)
    sxb = p.step_x * has
    qa = p.step_q * sal * has
    qb = p.step_q * has
    sgn = 2.0 * is_src - 1.0        # +1 src, -1 dst
    zcol = jnp.zeros((V,), jnp.float32)

    def pack(xb, w1b, w2b):
        cols = [xb, w1b, w2b] + [zcol] * (width - 3)
        return jnp.stack(cols, axis=1)

    def body(_, state):
        x, w1, w2, VB, q1, q2, q3 = state
        x_prev, w1_prev, w2_prev = x, w1, w2

        nb = VB[nbr]  # (V, D, width)
        xb_n, w1b_n, w2b_n = nb[..., 0], nb[..., 1], nb[..., 2]
        xb_s = VB[:, None, 0]
        w1b_s = VB[:, None, 1]
        w2b_s = VB[:, None, 2]

        # Edge fields in canonical (src, dst) orientation.
        xb_i = jnp.where(is_src > 0, xb_s, xb_n)
        xb_j = jnp.where(is_src > 0, xb_n, xb_s)
        w1b_i = jnp.where(is_src > 0, w1b_s, w1b_n)
        w1b_j = jnp.where(is_src > 0, w1b_n, w1b_s)
        w2b_i = jnp.where(is_src > 0, w2b_s, w2b_n)
        w2b_j = jnp.where(is_src > 0, w2b_n, w2b_s)

        K1 = (xb_i - xb_j) - sdx * w1b_i - sdy * w2b_i
        nq1 = _prox_conj(q1 + qa * K1)
        nq2 = _prox_conj(q2 + qb * (w1b_i - w1b_j))
        nq3 = _prox_conj(q3 + qb * (w2b_i - w2b_j))

        # Per-slot primal contribution to SELF.
        d_x = -sgn * nq1 * sxa
        d_w1 = is_src * nq1 * sxa * sdx - sgn * nq2 * sxb
        d_w2 = is_src * nq1 * sxa * sdy - sgn * nq3 * sxb

        nx = x + d_x.sum(1)
        nw1 = w1 + d_w1.sum(1)
        nw2 = w2 + d_w2.sum(1)

        nx = _prox_l1(p, weight, nx, g.data_term)
        nx = jnp.where(vmask, nx, x)
        nw1 = jnp.where(vmask, nw1, w1)
        nw2 = jnp.where(vmask, nw2, w2)

        xb = jnp.clip(nx + p.theta * (nx - x_prev), p.x_min, p.x_max)
        w1b = nw1 + p.theta * (nw1 - w1_prev)
        w2b = nw2 + p.theta * (nw2 - w2_prev)
        return (nx, nw1, nw2, pack(xb, w1b, w2b), nq1, nq2, nq3)

    init = (g.x, g.w1, g.w2, pack(g.x_bar, g.w1_bar, g.w2_bar),
            q0[..., 0], q0[..., 1], q0[..., 2])
    x, w1, w2, VB, q1, q2, q3 = jax.lax.fori_loop(0, n_iters, body, init)
    return x, w1, w2, VB, jnp.stack([q1, q2, q3], axis=-1)


def main_e():
    print(f"device: {jax.devices()[0]}")
    g, edges_np, n_e, tris_np, n_used = make_graph()
    p = RegularizerParams()
    N_IT = 40
    V = g.x.shape[0]

    ref = nltgv2.smooth(p, g, N_IT)
    ref_x = np.asarray(ref.x)

    for D in (16, 12):
        tabs = build_vertex_tables(np.asarray(g.edges), np.asarray(g.edge_mask),
                                   np.asarray(g.pos), np.asarray(g.alpha), V, D)
        # check no overflow
        deg = np.bincount(np.concatenate([np.asarray(g.edges)[np.asarray(g.edge_mask), 0],
                                          np.asarray(g.edges)[np.asarray(g.edge_mask), 1]]),
                          minlength=V)
        print(f"D={D}: max degree {deg.max()}, overflow verts {(deg > D).sum()}")
        tabs_d = [jnp.asarray(t) for t in tabs]
        q0 = jnp.zeros((V, D, 3), jnp.float32)
        for width in (4, 8):
            f = jax.jit(functools.partial(
                smooth_vertex_centric, p, width=width), static_argnums=(1,))
            out = f(g, N_IT, *tabs_d, q0)
            err = np.abs(np.asarray(out[0]) - ref_x).max()
            def run(f=f):
                np.asarray(f(g, N_IT, *tabs_d, q0)[0][0])
            dt = timeit(run, inner=N_IT)
            print(f"E vtx-centric D={D} w={width} {dt*1e3:7.3f} ms/iter  "
                  f"max|dx|={err:.2e}")


if __name__ == "__main__" and os.environ.get("EXP_E"):
    main_e()
