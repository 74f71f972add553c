"""Multi-device scaling model. The halo smoother's per-device
interconnect traffic is structural (two boundary strips per iteration,
independent of V) and its per-device work is the vertex block V/n. This
sweep runs n = 1/2/4/8 virtual devices and asserts:

  * results are invariant to the partitioning (same x at every n),
  * per-device halo bytes are CONSTANT in n and in V (boundary scaling),
  * per-device work (block rows) scales ~1/n and grows with V,
  * the edge-sharded psum smoother's traffic grows with V (volume
    scaling) — the contrast that motivates the halo design.

The instrumented counts come from halo.traffic_model /
sharding.psum_traffic_model, which the smoothers record at trace time
(the exchange structure is static).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flame_tpu.optimize import nltgv2
from flame_tpu.parallel import halo, sharding
from flame_tpu.params import RegularizerParams

from tests import _graphs

DEGREE = 16
REACH = 2
N_ITERS = 12


def make_graph(V_cap, E_cap, n_pts, seed=0):
    """A graph over [5, 500]^2 and its rank layout: (g, perm, inv,
    ranks)."""
    g, edges_sorted, n_e, member = _graphs.make_graph(
        V_cap, E_cap, DEGREE, seed=seed, n_pts=n_pts, span=500.0)
    assert n_e <= E_cap
    perm, inv, ranks = _graphs.rank_inputs(edges_sorted, n_e, member, V_cap,
                                           E_cap, DEGREE, REACH)
    return g, jnp.asarray(perm), jnp.asarray(inv), jnp.asarray(ranks)


RP = RegularizerParams()


def _run_halo(g, perm, inv, ranks, n_dev, halo_width):
    mesh = sharding.make_mesh(jax.devices()[:n_dev])
    out = halo.halo_smooth(RP, g, perm, inv, ranks, N_ITERS, DEGREE, mesh,
                           halo=halo_width)
    return np.asarray(out.x), dict(halo.LAST_TRAFFIC)


def test_halo_boundary_scaling_sweep():
    V = 2048
    g, perm, inv, ranks = make_graph(V, 8192, 1400)
    # One fixed strip width for every n (must fit the smallest block,
    # V/8): keeps the per-device byte count comparable across the sweep.
    halo_width = V // 8

    results, traffic = {}, {}
    for n in (1, 2, 4, 8):
        results[n], traffic[n] = _run_halo(g, perm, inv, ranks, n,
                                           halo_width)

    # Partitioning-invariant results (same smoothed x at every n).
    for n in (2, 4, 8):
        np.testing.assert_allclose(results[n], results[1], atol=2e-6)

    # Boundary scaling: per-device halo bytes constant in n; per-device
    # work (vertex block) scales exactly 1/n.
    for n in (2, 4, 8):
        assert traffic[n]["bytes_per_device_per_iter"] == \
            traffic[1]["bytes_per_device_per_iter"]
        assert traffic[n]["block_rows_per_device"] == V // n
        assert traffic[n]["collectives_per_iter"] == 2

    # Boundary not volume: doubling V leaves per-device halo bytes
    # unchanged while per-device work doubles...
    g2, p2, i2, r2 = make_graph(2 * V, 16384, 2800, seed=1)
    _, t2 = _run_halo(g2, p2, i2, r2, 8, halo_width)
    assert t2["bytes_per_device_per_iter"] == \
        traffic[8]["bytes_per_device_per_iter"]
    assert t2["block_rows_per_device"] == 2 * traffic[8][
        "block_rows_per_device"]

    # ...while the edge-sharded psum smoother's traffic DOUBLES with V
    # (volume scaling — the wrong asymptote as V grows).
    p_small = sharding.psum_traffic_model(V, 8, N_ITERS)
    p_big = sharding.psum_traffic_model(2 * V, 8, N_ITERS)
    assert p_big["bytes_per_device_per_iter"] == \
        2 * p_small["bytes_per_device_per_iter"]
    # At this scale the halo exchange is already far cheaper per device.
    assert traffic[8]["bytes_per_device_per_iter"] * 5 < \
        p_small["bytes_per_device_per_iter"]


def test_scaling_table_printout(capsys):
    """Regenerate the per-device traffic table from the models and
    sanity-check its numbers."""
    rows = []
    V, iters = 16384, 40
    for n in (1, 2, 4, 8, 16):
        h = halo.traffic_model(V, n, iters, halo=384)
        pm = sharding.psum_traffic_model(V, n, iters)
        rows.append((n, V // n, h["bytes_per_device_per_iter"],
                     pm["bytes_per_device_per_iter"]))
    for n, blk, hb, pb in rows:
        assert hb == 9216  # constant per device
        assert blk == V // n
        if n > 1:
            assert pb > 20 * hb  # psum volume vs halo boundary
        print(f"n={n:2d} block={blk:5d} halo_B/it={hb} psum_B/it={pb}")


def test_halo_clamp_drop_count_matches_rank_layout():
    """The host-side halo-clamp accounting (flame._host_triangulate's
    band counter) must equal the number of edges halo.rank_layout
    actually kills on device — the 'no silent truncation' invariant for
    the strip-width clamp. Uses a random (non-planar) graph whose RCM
    bandwidth far exceeds a small halo."""
    import jax.numpy as jnp
    V, E_cap, D, halo_w = 512, 4096, 16, 64
    rng = np.random.default_rng(7)
    a = rng.integers(0, V, 1200)
    b = rng.integers(0, V, 1200)
    keep = a != b
    e = np.sort(np.stack([a[keep], b[keep]], 1), axis=1)
    codes = e[:, 0] * V + e[:, 1]
    _, idx = np.unique(codes, return_index=True)
    e = e[np.sort(idx)]
    e = e[np.argsort(e[:, 0].astype(np.int64) * V + e[:, 1])]
    n_e = e.shape[0]
    member = np.zeros(V, bool)
    member[np.unique(e)] = True

    perm = halo.rcm_order(e, n_e, V, member)
    inv = np.empty(V, np.int32)
    inv[perm] = np.arange(V, dtype=np.int32)
    ranks = halo.perm_edge_ranks(e, n_e, inv, E_cap, D, REACH)

    # Host-side prediction (the counter formula in _host_triangulate).
    dist = np.abs(inv[e[:, 0]].astype(np.int64)
                  - inv[e[:, 1]].astype(np.int64))
    pred_extra = int(((dist > halo_w) & (ranks[:n_e, 0] != 255)).sum())
    pred_rank = int((ranks[:n_e, 0] == 255).sum())

    # Device-side truth: rank_layout's alive mask.
    g = nltgv2.empty(V, E_cap, D)
    edges_full = np.zeros((E_cap, 2), np.int64)
    edges_full[:n_e] = e
    g = g._replace(edges=jnp.asarray(edges_full.astype(np.int32)),
                   edge_mask=jnp.asarray(np.arange(E_cap) < n_e),
                   pos=jnp.asarray(rng.uniform(0, 100, (V, 2))
                                   .astype(np.float32)))
    *_, alive = halo.rank_layout(g, jnp.asarray(perm), jnp.asarray(inv),
                                 jnp.asarray(ranks.astype(np.int32)), D,
                                 halo_w)
    n_killed = n_e - int(np.asarray(alive).sum())
    assert pred_extra > 0  # the scenario actually exercises the clamp
    assert n_killed == pred_rank + pred_extra, \
        (n_killed, pred_rank, pred_extra)
