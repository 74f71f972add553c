"""Checkpoint/resume round trip: a restored pipeline must produce identical
outputs and continue updating."""

import os

import numpy as np
import jax.numpy as jnp

from flame_tpu.core.flame import Flame
from flame_tpu.geometry import se3, camera
from flame_tpu.utils import checkpoint

from test_flame_e2e import make_params, render, FX, W, H


def run_frames(fl, start, stop):
    for i in range(start, stop):
        cam_x = 0.15 * i
        pose = (se3.quat_identity(), jnp.array([cam_x, 0.0, 0.0]))
        fl.update(i * 0.1, i, pose, render(cam_x), i % 2 == 0)


def test_checkpoint_round_trip(tmp_path):
    params = make_params()
    K = camera.make_k(FX, FX, W / 2, H / 2)
    Kinv = camera.inv_k(K)

    fl = Flame(W, H, K, Kinv, params)
    run_frames(fl, 0, 8)
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save(path, fl)

    fl2 = Flame(W, H, K, Kinv, params)
    checkpoint.load(path, fl2)

    # Identical restored outputs.
    np.testing.assert_array_equal(fl2.get_inverse_depth_map(),
                                  fl.get_inverse_depth_map())
    v1, m1, _ = fl.get_raw_idepths()
    v2, m2, _ = fl2.get_raw_idepths()
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(m1, m2)
    assert fl2.num_data_updates == fl.num_data_updates
    assert fl2._pf_slot_by_id == fl._pf_slot_by_id

    # Restored instance must keep processing.
    run_frames(fl2, 8, 11)
    assert fl2.num_data_updates > fl.num_data_updates
    idm = fl2.get_inverse_depth_map()
    assert np.mean(~np.isnan(idm)) > 0.2


def test_checkpoint_midbatch_ba_bit_equal_resume(tmp_path):
    """Save mid-batch under frame_batch=4 with BA history.
    save() quiesces (flushes the pending batch + drains async staging),
    so the saved-and-continued run and the restored-and-continued run
    proceed from identical state — the resumed trajectory must be
    BIT-EQUAL, and the BA observation store must survive."""
    import dataclasses
    from flame_tpu.params import BAParams

    params = make_params()
    params = params.replace(
        do_ba=True,
        # solve_min_new_pfs=3: the solve-cadence watermark must
        # round-trip (a resumed run would otherwise stage its next
        # solve earlier than the continued one).
        ba=BAParams(window_size=4, n_gn_iters=2, obs_capacity=2048,
                    max_landmarks=256, max_obs=512, solve_min_new_pfs=3),
        # deterministic=True pins the async fetch/triangulation joins to
        # their staging points; the opportunistic joins depend on thread
        # wall-clock and would make bit-reproducibility a coin flip.
        solver=dataclasses.replace(params.solver, frame_batch=4,
                                   async_topology=True,
                                   deterministic=True))
    K = camera.make_k(FX, FX, W / 2, H / 2)
    Kinv = camera.inv_k(K)

    def run_frames(fl, start, stop):  # uint8 images: batching engages
        for i in range(start, stop):
            cam_x = 0.15 * i
            pose = (se3.quat_identity(), jnp.array([cam_x, 0.0, 0.0]))
            img = np.clip(render(cam_x), 0, 255).astype(np.uint8)
            fl.update(i * 0.1, i, pose, img, i % 2 == 0)

    fl = Flame(W, H, K, Kinv, params)
    run_frames(fl, 0, 13)  # 13 frames: one frame buffered mid-batch
    assert len(fl._batch_pending) > 0, "mid-batch save must have pending"
    # Prune several poseframes first: the freed-slot LIST ORDER feeds
    # future slot allocation, so it must round-trip verbatim (a sorted
    # reconstruction would make resumed allocations diverge).
    # (prune flushes the pending batch, which promotes frame 12 to the
    # current poseframe — it must be in keep_ids.)
    keep = sorted(fl._pf_slot_by_id)[-3:] + [12]
    fl.prune_poseframes(keep)
    assert len(fl._pf_free) >= 2
    # Refill the batch buffer so the save itself happens MID-BATCH.
    run_frames(fl, 13, 19)
    assert len(fl._batch_pending) > 0, "save must happen mid-batch"
    path = os.path.join(tmp_path, "ckpt_mid.npz")
    checkpoint.save(path, fl)
    assert not fl._batch_pending  # quiesced: buffered frames flushed
    assert len(fl._ba.store) > 0  # BA history exists at save time
    n_obs_saved = len(fl._ba.store)

    fl2 = Flame(W, H, K, Kinv, params)
    checkpoint.load(path, fl2)
    assert len(fl2._ba.store) == n_obs_saved  # history restored
    np.testing.assert_array_equal(
        np.asarray(fl._feats.idepth_mu), np.asarray(fl2._feats.idepth_mu))

    # Continue BOTH runs identically; trajectories must stay bit-equal.
    run_frames(fl, 19, 28)
    run_frames(fl2, 19, 28)
    a = fl.get_inverse_depth_map()
    b = fl2.get_inverse_depth_map()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(fl._feats.idepth_mu),
                                  np.asarray(fl2._feats.idepth_mu))
    np.testing.assert_array_equal(np.asarray(fl._graph.x),
                                  np.asarray(fl2._graph.x))
    assert len(fl._ba.store) == len(fl2._ba.store)
    assert np.mean(~np.isnan(b)) > 0.2


def test_restore_tracks_inflight_transfers_as_zombies(tmp_path):
    """Restoring over a LIVE instance with in-flight packed transfers
    must keep their un-cancellable fetches on the zombie list (the
    in-flight depth cap counts them) and reset the shed/latency state the
    snapshot does not carry."""
    params = make_params()
    K = camera.make_k(FX, FX, W / 2, H / 2)
    Kinv = camera.inv_k(K)
    fl = Flame(W, H, K, Kinv, params)
    run_frames(fl, 0, 8)
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save(path, fl)

    fl2 = Flame(W, H, K, Kinv, params)

    class StuckFetch:
        t_done = None
        _exc = None

        def ready(self):
            return False

    fl2._packed_queue.append((StuckFetch(), 3, ([3], [False]), [None]))
    fl2._packed_queue.append((StuckFetch(), 4, ([4], [False]), [None]))
    fl2._sheds_since_consume = 7
    fl2._latency_samples = [1.0, 2.0]
    fl2._entry_stamp[99] = 0.0
    checkpoint.load(path, fl2)

    assert not fl2._packed_queue
    assert len(fl2._zombie_fetches) == 2  # still occupying in-flight slots
    assert fl2._in_flight_fetches() == 2
    assert fl2._sheds_since_consume == 0
    assert fl2._latency_samples == [] and fl2._entry_stamp == {}
    # The restored instance must still run.
    run_frames(fl2, 8, 10)
