"""Flow-control tests for the bounded-shed packed-fetch policy.

The update thread must never block on a stale in-flight transfer while
shed budget remains (the reference's update thread never blocks on its
worker threads either — flame.cc:98-116); past the budget the head join
becomes blocking so the host mirror cannot drift unboundedly. These
tests drive Flame._drain_packed_queue directly with controllable fake
transfers (the CPU backend's transfers land instantly, so real transfer
stalls cannot be reproduced here), plus one end-to-end run under an
artificially delayed fetch.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import flame_tpu.core.flame as flame_mod
from flame_tpu.core.flame import Flame
from flame_tpu.geometry import se3, camera
from flame_tpu.params import Params, DetectionParams, SolverParams

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    return (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
            + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X)).astype(
                np.float32)


def make_params(**solver_kw):
    kw = dict(n_iters_per_frame=10, max_vertex_degree=16,
              async_topology=True)
    kw.update(solver_kw)
    return Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(**kw), debug_quiet=True)


class FakeFetch:
    """Stand-in for _AsyncFetch with a controllable landing state."""

    def __init__(self, ready=False):
        self._ready = ready
        self._exc = None
        self.t_start = 100.0
        self.t_done = 100.05 if ready else None
        self.joined = False

    def ready(self):
        return self._ready

    def get(self):
        # A blocking join: the transfer "lands" now.
        self.joined = True
        self._ready = True
        if self.t_done is None:
            self.t_done = 100.2
        return np.zeros((4, 3), np.uint16)


def make_policy_flame(**solver_kw):
    p = make_params(join_age=4, **solver_kw)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = Flame(W, H, K, camera.inv_k(K), p)
    fl._consumed = []
    fl._consume_packed = lambda pk, fr, meta: (
        fl._consumed.append(fr) or True)
    return fl


def stat(fl, name):
    return fl.stats.snapshot()["stats"].get(name, 0)


def test_young_inflight_head_is_left_alone():
    fl = make_policy_flame()
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 10, ([10], [True]), [None]))
    fl.num_imgs = 12  # age 2 < join_age 4
    assert fl._drain_packed_queue()
    assert len(fl._packed_queue) == 1 and not pk.joined
    assert not fl._consumed and stat(fl, "packed_sheds") == 0


def test_ready_head_consumed_and_resets_shed_counter():
    fl = make_policy_flame()
    fl._sheds_since_consume = 3
    fl._packed_queue.append((FakeFetch(ready=True), 10, ([10], [True]),
                             [99.95]))
    fl.num_imgs = 11
    assert fl._drain_packed_queue()
    assert fl._consumed == [10]
    assert fl._sheds_since_consume == 0
    # Latency sample harvested: t_done (100.05) - t_entry (99.95) = 100ms.
    p50, p95 = fl.latency_percentiles()
    assert abs(p50 - 100.0) < 1e-6 and abs(p95 - 100.0) < 1e-6


def test_stale_head_is_shed_not_joined():
    fl = make_policy_flame()
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 10, ([10, 11], [True, False]),
                             [None, None]))
    fl.num_imgs = 14  # age 4 >= join_age 4
    assert fl._drain_packed_queue()
    assert not fl._packed_queue and not pk.joined
    assert not fl._consumed
    assert stat(fl, "packed_sheds") == 1
    assert fl._sheds_since_consume == 1
    # A shed is an unready transfer: the readiness EMA must record it
    # (else the stat reads lagging transfers as ready).
    assert stat(fl, "fetch_ready_frac") < 1.0
    # The un-cancellable transfer holds its link slot until it lands.
    assert fl._in_flight_fetches() == 1
    pk._ready = True
    pk.t_done = 100.3
    assert fl._in_flight_fetches() == 0  # reaped once landed


def test_shed_notes_ba_obs_drop():
    fl = make_policy_flame()
    fl._ba = object()  # _note_ba_obs_drop touches only stats + a flag
    fl._packed_queue.append((FakeFetch(ready=False), 10,
                             ([10, 11], [True, True]), [None, None]))
    fl.num_imgs = 20
    assert fl._drain_packed_queue()
    assert stat(fl, "ba_obs_dropped_pfs") == 2


def test_exhausted_budget_forces_blocking_join():
    fl = make_policy_flame(max_consecutive_sheds=2)
    fl._sheds_since_consume = 2
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 10, ([10], [False]), [None]))
    fl.num_imgs = 20
    assert fl._drain_packed_queue()
    assert pk.joined  # the drift-bound backstop blocked for it
    assert fl._consumed == [10]
    assert fl._sheds_since_consume == 0
    assert stat(fl, "packed_sheds") == 0


def test_sheds_disabled_restores_blocking_behavior():
    fl = make_policy_flame(max_consecutive_sheds=0)
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 10, ([10], [False]), [None]))
    fl.num_imgs = 14
    assert fl._drain_packed_queue()
    assert pk.joined and fl._consumed == [10]
    assert stat(fl, "packed_sheds") == 0


def test_consecutive_sheds_then_backstop():
    """Budget counts sheds across drains until a consume: two stale heads
    shed, the third forces a join."""
    fl = make_policy_flame(max_consecutive_sheds=2)
    fl.num_imgs = 20
    for i in range(2):
        fl._packed_queue.append((FakeFetch(ready=False), 10 + i,
                                 ([i], [False]), [None]))
        assert fl._drain_packed_queue()
    assert stat(fl, "packed_sheds") == 2 and not fl._consumed
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 12, ([2], [False]), [None]))
    assert fl._drain_packed_queue()
    assert pk.joined and fl._consumed == [12]


def test_staging_respects_zombie_link_slots():
    """Shed transfers keep occupying an in-flight slot until they land:
    staging depth counts them."""
    fl = make_policy_flame()
    z1, z2 = FakeFetch(ready=False), FakeFetch(ready=False)
    fl._zombie_fetches = [(z1, None), (z2, None)]
    assert fl._in_flight_fetches() == 2  # == topology_lag: no room
    z1._ready = True
    z1.t_done = 100.1
    assert fl._in_flight_fetches() == 1


def test_zombie_transfer_error_is_counted_not_raised():
    fl = make_policy_flame()
    pk = FakeFetch(ready=True)
    pk._exc = RuntimeError("link reset")
    fl._zombie_fetches = [(pk, None)]
    fl._reap_zombies()  # must not raise
    assert stat(fl, "zombie_fetch_errors") == 1
    assert not fl._zombie_fetches


def test_e2e_with_delayed_fetches(monkeypatch):
    """Full pipeline under an artificially slow link: every transfer
    reports not-ready for its first few polls, forcing the stale-head
    path. The run must shed (not stall), stay numerically healthy, and
    still produce a dense map once transfers land."""
    real_fetch = flame_mod._AsyncFetch

    class SlowFetch(real_fetch):
        delay_polls = 6

        def __init__(self, dev_arr, post=None):
            super().__init__(dev_arr, post)
            self._polls = 0

        def ready(self):
            self._polls += 1
            if self._polls <= self.delay_polls:
                return False
            return super().ready()

    monkeypatch.setattr(flame_mod, "_AsyncFetch", SlowFetch)
    params = make_params(join_age=2, max_consecutive_sheds=3)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = Flame(W, H, K, camera.inv_k(K), params)
    for i in range(16):
        cam_x = 0.15 * i
        pose = (se3.quat_identity(), jnp.array([cam_x, 0.0, 0.0]))
        fl.update(i * 0.1, i, pose, render(cam_x), i % 2 == 0)
    s = fl.stats.snapshot()["stats"]
    assert s.get("packed_sheds", 0) > 0  # the slow link forced sheds
    idm = fl.get_inverse_depth_map()
    cov = np.mean(~np.isnan(idm))
    assert cov > 0.3  # map still dense despite the shed topology refreshes
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z
    assert np.median(err) < 0.05
    # Latency samples were harvested from consumed + landed-zombie fetches.
    assert fl.latency_percentiles() is not None
