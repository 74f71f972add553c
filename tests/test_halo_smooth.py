"""Vertex-partitioned halo-exchange smoother vs the reference step
(8 virtual CPU devices via conftest; mesh over 4 of them)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from flame_tpu.optimize import nltgv2
from flame_tpu.parallel import halo
from flame_tpu.params import RegularizerParams

from tests._graphs import make_graph, rank_inputs

V_CAP = 1024
E_CAP = 4096
DEGREE = 16
HALO = 256


def _rank_inputs(edges_sorted, n_e, member, reach, degree=DEGREE):
    return rank_inputs(edges_sorted, n_e, member, V_CAP, E_CAP, degree,
                       reach)


@pytest.fixture(scope="module")
def setup():
    g, edges_sorted, n_e, member = make_graph(V_CAP, E_CAP, DEGREE, seed=3,
                                              n_pts=700)
    perm, inv, ranks = _rank_inputs(edges_sorted, n_e, member,
                                    reach=HALO // halo.LANES - 1)
    assert (ranks[:n_e] < 255).all(), "drops in test graph"
    return g, jnp.asarray(perm), jnp.asarray(inv), jnp.asarray(ranks)


def test_rcm_band_within_reach():
    """Every edge perm_edge_ranks keeps spans at most `reach` rank rows,
    and the RCM order is a permutation with the members first."""
    _, edges_sorted, n_e, member = make_graph(V_CAP, E_CAP, DEGREE, seed=3,
                                              n_pts=700)
    reach = 1
    perm, inv, ranks = _rank_inputs(edges_sorted, n_e, member, reach)
    assert np.array_equal(np.sort(perm), np.arange(V_CAP))
    assert member[perm[:member.sum()]].all()
    kept = ranks[:n_e, 0] != 255
    lo = inv[edges_sorted[:n_e, 0]] // halo.LANES
    hi = inv[edges_sorted[:n_e, 1]] // halo.LANES
    assert kept.any()
    assert (np.abs(lo - hi)[kept] <= reach).all()


def test_rank_drops_symmetric():
    """A band or degree overflow on either endpoint drops the edge on BOTH
    (255 in both rank columns), so the two dual copies stay identical;
    kept edges hold distinct slots below the degree on each vertex."""
    _, edges_sorted, n_e, member = make_graph(V_CAP, E_CAP, DEGREE, seed=3,
                                              n_pts=700)
    degree = 5  # below the Delaunay degree of many vertices
    perm, inv, ranks = _rank_inputs(edges_sorted, n_e, member, reach=0,
                                    degree=degree)
    r = ranks[:n_e]
    dropped = (r[:, 0] == 255) | (r[:, 1] == 255)
    assert dropped.any() and not dropped.all()
    assert ((r[:, 0] == 255) == (r[:, 1] == 255)).all()
    assert (r[~dropped] < degree).all()
    # Each vertex's kept slots are distinct (src and dst never collide).
    lo = inv[edges_sorted[:n_e, 0]][~dropped]
    hi = inv[edges_sorted[:n_e, 1]][~dropped]
    slot = np.concatenate([lo * degree + r[~dropped, 0],
                           hi * degree + r[~dropped, 1]])
    assert np.unique(slot).shape[0] == slot.shape[0]


def test_matches_reference_step(setup):
    g, perm, inv, ranks = setup
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = Mesh(np.asarray(jax.devices()[:4]), (halo.AXIS,))
    p = RegularizerParams()

    ref = nltgv2.smooth(p, g, 6, mode="step")
    out = halo.halo_smooth(p, g, perm, inv, ranks, 6, DEGREE, mesh,
                           halo=HALO)

    vm = np.asarray(g.vtx_mask)
    em = np.asarray(g.edge_mask)
    for name in ("x", "w1", "w2", "x_bar"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name))[vm],
            np.asarray(getattr(ref, name))[vm],
            rtol=2e-5, atol=5e-6, err_msg=name)
    for name in ("q1", "q2", "q3"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name))[em],
            np.asarray(getattr(ref, name))[em],
            rtol=2e-4, atol=5e-5, err_msg=name)


def test_energy_decreases(setup):
    g, perm, inv, ranks = setup
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = Mesh(np.asarray(jax.devices()[:4]), (halo.AXIS,))
    p = RegularizerParams()
    e0 = float(nltgv2.energy(p, g))
    out = halo.halo_smooth(p, g, perm, inv, ranks, 60, DEGREE, mesh,
                           halo=HALO)
    assert float(nltgv2.energy(p, out)) < e0
