"""Two-frames-per-dispatch orchestration (solver.frame_batch=2,
pipeline.batch_step): quality parity with the single-frame path on a
synthetic sequence, flush semantics of the buffered frame, and the
degenerate-topology guards that pair-scale staleness exposed
(optimize.topology.MIN_EDGE_LENGTH, snapshot dedupe)."""

import numpy as np
import jax.numpy as jnp
import pytest

from flame_tpu.core.flame import Flame
from flame_tpu.geometry import se3, camera
from flame_tpu.params import Params, DetectionParams, SolverParams

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0


def tex(X, Y):
    return (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
            + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X))


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    return np.clip(tex(X, Y), 0, 255).astype(np.uint8)


def make_flame(frame_batch):
    params = Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            async_topology=True, coalesce_uploads=True,
                            frame_batch=frame_batch, smoother="vertex"),
        debug_quiet=True)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    return Flame(W, H, K, camera.inv_k(K), params)


def drive(fl, n, start=0):
    for i in range(start, start + n):
        cam_x = 0.15 * i
        fl.update(i * 0.1, i, (se3.quat_identity(),
                               jnp.array([cam_x, 0.0, 0.0])),
                  render(cam_x), i % 2 == 0)


@pytest.fixture(scope="module")
def paired():
    fl = make_flame(2)
    drive(fl, 20)
    return fl


def test_pair_mode_engages(paired):
    assert paired._dispatches >= 5  # pairs actually dispatched


def test_pair_quality_matches_single(paired):
    fl1 = make_flame(1)
    drive(fl1, 20)
    idm2 = paired.get_inverse_depth_map()
    idm1 = fl1.get_inverse_depth_map()
    cov2 = np.mean(~np.isnan(idm2))
    cov1 = np.mean(~np.isnan(idm1))
    err2 = np.nanmedian(np.abs(idm2 - 1 / PLANE_Z)) * PLANE_Z
    err1 = np.nanmedian(np.abs(idm1 - 1 / PLANE_Z)) * PLANE_Z
    assert cov2 > 0.9 * cov1
    assert err2 < max(2.0 * err1, 0.01)


def test_batch4_quality_matches_single(paired):
    """frame_batch=4: the scan-based batch path at depth 4 must hold the
    same quality as the per-frame path (one dispatch per 4 frames)."""
    fl4 = make_flame(4)
    drive(fl4, 20)
    assert fl4._dispatches >= 3
    idm4 = fl4.get_inverse_depth_map()
    idm2 = paired.get_inverse_depth_map()
    cov4 = np.mean(~np.isnan(idm4))
    cov2 = np.mean(~np.isnan(idm2))
    err4 = np.nanmedian(np.abs(idm4 - 1 / PLANE_Z)) * PLANE_Z
    assert cov4 > 0.85 * cov2
    assert err4 < 0.02


def test_resident_image_batching(paired):
    """Device-resident uint8 frames engage the batch path through
    batch_step's imgs-tuple executable (only topology words uploaded) and
    hold quality parity with host-image batching."""
    import jax
    fl = make_flame(2)
    for i in range(20):
        cam_x = 0.15 * i
        fl.update(i * 0.1, i, (se3.quat_identity(),
                               jnp.array([cam_x, 0.0, 0.0])),
                  jax.device_put(render(cam_x)), i % 2 == 0)
    assert fl._dispatches >= 5
    idm = fl.get_inverse_depth_map()
    idm2 = paired.get_inverse_depth_map()
    cov = np.mean(~np.isnan(idm))
    cov2 = np.mean(~np.isnan(idm2))
    err = np.nanmedian(np.abs(idm - 1 / PLANE_Z)) * PLANE_Z
    assert cov > 0.9 * cov2
    assert err < 0.02


def test_getter_flushes_pending_frame(paired):
    # Drive an odd number of frames so one is buffered, then call a
    # getter: the buffered frame must be processed (mesh getter path).
    drive(paired, 1, start=20)
    if paired._batch_pending:
        paired.get_inverse_depth_map()
    assert not paired._batch_pending


def test_raw_idepths_accurate(paired):
    verts, mu, var = paired.get_raw_idepths()
    assert mu.shape[0] > 50
    assert np.median(np.abs(mu - 1 / PLANE_Z)) * PLANE_Z < 0.05


def test_failure_stats_and_mesh(paired):
    s = paired.failure_stats()
    assert s["updates"] > 0
    mesh = paired.get_inverse_depth_mesh()
    assert mesh["triangles"].shape[0] > 50
    assert np.isfinite(mesh["vertices"]).all()


def test_prune_without_current_pf_raises(paired):
    ids = sorted(paired._pf_slot_by_id.keys())
    assert len(ids) >= 2
    with pytest.raises(ValueError):
        paired.prune_poseframes(ids[:-1])  # drops the current poseframe
    # State untouched by the rejected call.
    assert sorted(paired._pf_slot_by_id.keys()) == ids


def test_alpha_clamped():
    """Degenerate (sub-pixel) edges must not produce exploding alpha
    (the Chambolle-Pock instability found at pair-scale staleness)."""
    from flame_tpu.optimize import topology
    pos = jnp.asarray(np.array([[10.0, 10.0], [10.001, 10.0],
                                [30.0, 10.0], [20.0, 25.0]], np.float32))
    edges = np.array([[0, 1], [0, 2], [1, 3]], np.int64)
    pad = np.zeros((16, 2), np.int64)
    pad[:3] = edges
    topo = topology.from_edges(
        jnp.asarray(pad), 3, pos, jnp.asarray(pad),
        jnp.zeros(16, bool), jnp.zeros(16), jnp.zeros(16), jnp.zeros(16),
        16, 4, 4)
    alpha = np.asarray(topo.alpha)
    assert alpha[0] <= 1.0 / topology.MIN_EDGE_LENGTH + 1e-6
    assert alpha[1] == pytest.approx(1.0 / 20.0)


def test_capacity_truncation_counted():
    """Overflowing a deliberately tiny triangle/edge capacity must be
    counted, not silent."""
    from flame_tpu.core import pipeline
    params = Params(
        feature_capacity=256, edge_capacity=16, triangle_capacity=8,
        poseframe_capacity=4, min_height=-1e6, max_height=1e6,
        solver=SolverParams(max_vertex_degree=8, smoother="vertex"),
        debug_quiet=True)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = Flame(W, H, K, camera.inv_k(K), params)
    rng = np.random.default_rng(0)
    pk = np.zeros((256, 3), np.uint16)
    flags = (pipeline.PACK_MEMBER | pipeline.PACK_CURR_VALID
             | pipeline.PACK_FEAT_VALID)
    for i in range(64):
        pk[i, 0] = int(rng.uniform(10, 150) * pipeline.PACK_XY_SCALE)
        pk[i, 1] = int(rng.uniform(10, 110) * pipeline.PACK_XY_SCALE)
        pk[i, 2] = flags
    res = fl._host_triangulate(pk)
    assert res is not None
    stats = fl.failure_stats()
    assert stats["tris_truncated"] > 0
    assert stats["edges_truncated"] > 0


def test_snapshot_dedupe():
    """Coincident packed positions are deduped before Delaunay."""
    from flame_tpu.core import pipeline
    fl = make_flame(1)
    N = fl.params.feature_capacity
    pk = np.zeros((N, 3), np.uint16)
    # 4 members, two of them at the identical packed position.
    xs = [(320, 240), (320, 240), (960, 240), (640, 720)]
    for i, (x, y) in enumerate(xs):
        pk[i, 0] = x
        pk[i, 1] = y
        pk[i, 2] = (pipeline.PACK_MEMBER | pipeline.PACK_CURR_VALID
                    | pipeline.PACK_FEAT_VALID)
    res = fl._host_triangulate(pk)
    assert res is not None
    buf, n_tris, tris_slots, edges_sorted, n_edges = res
    assert n_tris == 1  # the duplicate collapsed: one triangle remains
    assert 1 not in set(tris_slots.reshape(-1).tolist())


def test_batch_tracking_bit_equal_sequential():
    """The scan-based batch body must reproduce the sequential per-frame
    tracking EXACTLY given identical pre-dispatch state (the PARITY.md
    claim, qualified: later batch frames legitimately
    see the batch-start smoothing/seed cadence, so the equality statement
    is about the tracking/measurement/fusion chain itself). Compares
    batch_step (B=2, detection off) against two frame_track_step
    dispatches bit-for-bit."""
    import __graft_entry__ as ge
    import jax
    from flame_tpu.core import pipeline
    from flame_tpu.optimize import nltgv2

    params = ge._small_params()
    Hh, Ww = 96, 128
    K, Kinv, stack, feats, fnew, graph = ge._synthetic_state(params, Hh, Ww)

    rng = np.random.default_rng(3)
    vv, uu = np.mgrid[0:Hh, 0:Ww].astype(np.float64)
    imgs = [np.clip(128 + 60 * np.sin(0.5 * (uu + 2.0 * i))
                    + 30 * np.cos(0.3 * vv), 0, 255).astype(np.uint8)
            for i in (1, 2)]
    poses = [(se3.quat_identity(), jnp.array([0.1 * i, 0.0, 0.0]))
             for i in (1, 2)]
    seed = jnp.full((Hh, Ww), jnp.nan, jnp.float32)
    prev_q, prev_t = fnew.q, fnew.t

    # --- Sequential: two frame_track_step dispatches.
    f_s, fe_s = None, feats
    st_s = stack
    obs_seq, packed_seq = [], None
    pq, pt = prev_q, prev_t
    for b, (im, (q, t)) in enumerate(zip(imgs, poses)):
        (f_s, st2, fe_s, curr_s, member_s, _stats, obs, packed_seq) = \
            pipeline.frame_track_step(
                params, K, Kinv, st_s, fe_s, jnp.asarray(im),
                jnp.int32(10 + b), q, t, 0, pq, pt, jnp.int32(0), seed,
                do_detect=False, do_insert=(b == 0),
                height=Hh, width=Ww)
        if st2 is not None:
            st_s = st2
        obs_seq.append(obs)
        pq, pt = f_s.q, f_s.t

    # --- Batched: one batch_step dispatch over the same two frames.
    topo_words = 2 + 3 * params.triangle_capacity + 3 * params.edge_capacity
    buf = jnp.zeros((2 * topo_words,), jnp.uint8)
    dev_imgs = tuple(jnp.asarray(im) for im in imgs)
    (f_b, st_b, fe_b, curr_b, member_b, _stats_b, obs_b, packed_b,
     *_rest) = pipeline.batch_step(
        params, K, Kinv, stack, feats, graph, jnp.float32(1.0), buf,
        np.array([10, 11], np.int32), tuple(p[0] for p in poses),
        tuple(p[1] for p in poses), np.array([True, False]),
        np.array([False, False]), np.array([0, 0], np.int32),
        np.array([0, 0], np.int32), prev_q, prev_t, prev_q, prev_t,
        seed, jnp.asarray(False), n_frames=2, height=Hh, width=Ww,
        imgs=dev_imgs)

    for fld in fe_s._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(fe_s, fld)), np.asarray(getattr(fe_b, fld)),
            err_msg=f"feats.{fld}")
    for b in range(2):
        for fld in obs_seq[b]._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(obs_seq[b], fld)),
                np.asarray(jax.tree.map(lambda a: a[b], obs_b)._asdict()[fld]),
                err_msg=f"obs[{b}].{fld}")
    np.testing.assert_array_equal(np.asarray(packed_seq),
                                  np.asarray(packed_b))
    np.testing.assert_array_equal(np.asarray(member_s),
                                  np.asarray(member_b))
    for fld in curr_s._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(curr_s, fld)), np.asarray(getattr(curr_b, fld)),
            err_msg=f"curr.{fld}")


def test_per_frame_dense_maps_in_batch():
    """Each poseframe inside a batch must receive ITS OWN per-frame dense
    map (reference rasterizes inside every update, flame.cc:409-415) —
    not one batch-end map copied to all."""
    fl = make_flame(4)
    drive(fl, 24)
    assert fl._dispatches >= 3
    slots = [fl._pf_slot_by_id[fid] for fid in sorted(fl._pf_slot_by_id)]
    maps = [np.asarray(fl._stack.idepthmap[s]) for s in slots]
    covs = [float(np.mean(~np.isnan(m))) for m in maps]
    populated = [m for m, c in zip(maps, covs) if c > 0.3]
    assert len(populated) >= 3, covs
    # Two poseframes from the same batch see the scene from different
    # camera positions; their stashed maps must differ.
    diffs = []
    for a, b in zip(populated[:-1], populated[1:]):
        both = ~np.isnan(a) & ~np.isnan(b)
        if both.sum() > 100:
            diffs.append(float(np.max(np.abs(a[both] - b[both]))))
    assert diffs and max(diffs) > 1e-6, diffs
