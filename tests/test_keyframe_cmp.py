"""Device-side comparison-poseframe selection (reference getPoseFrame,
/root/reference/src/flame/flame.cc:775-820): score_jax parity with the
host score(), best_comparison_pose ranking, and the end-to-end guarantee
that detection keeps firing when the previous frame is a degenerate
(near-zero-baseline) stereo partner but an older poseframe is good."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flame_tpu.core import keyframe
from flame_tpu.geometry import se3, camera


W, H = 160, 120
FX = 100.0


@pytest.fixture(scope="module")
def kk():
    K = camera.make_k(FX, FX, W / 2, H / 2)
    return np.asarray(K, np.float64), np.asarray(camera.inv_k(K), np.float64)


def _rand_pose(rng, t_scale=0.5, angle_scale=0.3):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(-angle_scale, angle_scale)
    q = np.array([np.cos(ang / 2), *(np.sin(ang / 2) * axis)])
    t = rng.normal(size=3) * t_scale
    return q, t


def test_score_jax_matches_host(kk):
    """Host score() is now a thin wrapper over score_jax (the r3 review
    flagged the former separate f64 implementation as drift risk), so
    wrapper-vs-jax agreement is exact by construction; this still checks
    the wrapper plumbing (dtype conversion, CPU placement, sentinel)."""
    K, Kinv = kk
    rng = np.random.default_rng(7)
    n_checked = 0
    for _ in range(40):
        q, t = _rand_pose(rng)
        s_host = keyframe.score(W, H, K, Kinv, q, t)
        s_dev = float(keyframe.score_jax(W, H, K, Kinv, q, t))
        if s_host <= keyframe._SCORE_LOWEST / 2:
            assert s_dev <= keyframe._SCORE_LOWEST / 2, (q, t)
        else:
            assert s_dev == pytest.approx(s_host, abs=2e-3), (q, t)
            n_checked += 1
    assert n_checked >= 10  # the sampler must produce plenty of live scores


def test_score_regression_values():
    """Pin score() against values computed by the retired independent
    f64 numpy implementation (captured before its removal) — guards the
    shared score_jax formulation against silent drift at VGA geometry."""
    K = np.asarray(camera.make_k(525.0, 525.0, 320.0, 240.0), np.float64)
    Kinv = np.linalg.inv(K)
    cases = [
        (np.array([1.0, 0, 0, 0]), np.array([0.5, 0, 0]), 0.36678404),
        (np.array([1.0, 0, 0, 0]), np.array([0.05, 0, 0]), 1.26167841),
        (np.array([0.9961947, 0, 0.08715574, 0]), np.array([0.3, 0, 0]),
         1.27437774),  # 10 deg yaw
        (np.array([0.9848078, 0.17364818, 0, 0]), np.array([0.0, 0.2, 0]),
         1.32979037),  # 20 deg pitch
        (np.array([1.0, 0, 0, 0]), np.array([0.0, 0.0, -0.5]), 0.99999987),
    ]
    for q, t, want in cases:
        got = keyframe.score(640, 480, K, Kinv, q, t)
        assert got == pytest.approx(want, abs=2e-3), (q, t)


def test_score_jax_rejects_large_rotation(kk):
    K, Kinv = kk
    # 90-degree yaw: past the 60-degree orientation cutoff.
    q = np.array([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0])
    assert float(keyframe.score_jax(W, H, K, Kinv, q, np.zeros(3))) \
        <= keyframe._SCORE_LOWEST / 2


def _roll_quat(deg):
    # Roll about the optical axis: corners stay in front of the camera
    # and overlap stays large, so only the orientation cutoff (which
    # depends on |q_w| alone) decides near 60 degrees — a yaw of that
    # size would trip the behind-camera gate first at this FOV.
    ang = np.radians(deg)
    return np.array([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)])


def test_orientation_cutoff_boundary_band(kk):
    """The 60-degree hard cutoff runs in f32 (score_jax serves both the
    device AND the host score() since r4); pin the accept/reject flip to
    a band far narrower than any caller cares about, so f32 rounding
    cannot silently move the boundary. The score's local
    sensitivity at the cutoff is d s/d theta = sin(120 deg) ~ 0.87 per
    radian, so f32 resolution locates the flip to ~1e-7 rad; we assert
    +/-0.005 deg (9e-5 rad), three orders of margin. A good sideways
    baseline keeps the non-orientation gates (overlap, disparity) alive
    so only the cutoff decides."""
    K, Kinv = kk
    t = np.array([0.5, 0.0, 0.0])
    for deg in (59.95, 59.995):
        s = float(keyframe.score_jax(W, H, K, Kinv, _roll_quat(deg), t))
        assert s > keyframe._SCORE_LOWEST / 2, deg
    for deg in (60.005, 60.05):
        s = float(keyframe.score_jax(W, H, K, Kinv, _roll_quat(deg), t))
        assert s <= keyframe._SCORE_LOWEST / 2, deg
    # Host wrapper agrees with the device scorer ON the boundary band
    # (same implementation — this guards the wrapper's f32 conversions).
    for deg in (59.995, 60.005):
        sh = keyframe.score(W, H, K, Kinv, _roll_quat(deg), t)
        sd = float(keyframe.score_jax(W, H, K, Kinv, _roll_quat(deg), t))
        assert (sh > keyframe._SCORE_LOWEST / 2) \
            == (sd > keyframe._SCORE_LOWEST / 2), deg


def test_behind_camera_boundary_is_clean(kk):
    """Corners at z <= 0 in the candidate frame must hard-reject with
    the sentinel; corners just in FRONT (z ~ +1e-3, a near-degenerate
    divide) must still produce a finite score — the z-guarded divides
    may never leak NaN/Inf on either side of the boundary. (The
    just-in-front pose is legitimately ACCEPTED: its huge projected
    quad contains the whole image, i.e. full frustum overlap.)"""
    K, Kinv = kk
    for dz in (-60.0, -50.0):  # max_depth=50: corner z = 50 + dz <= 0
        s = float(keyframe.score_jax(
            W, H, K, Kinv, np.array([1.0, 0, 0, 0]),
            np.array([0.0, 0.0, dz])))
        assert np.isfinite(s)
        assert s <= keyframe._SCORE_LOWEST / 2, dz
    s = float(keyframe.score_jax(
        W, H, K, Kinv, np.array([1.0, 0, 0, 0]),
        np.array([0.0, 0.0, -49.999])))  # corner z = +1e-3
    assert np.isfinite(s)
    assert s > keyframe._SCORE_LOWEST / 2


def test_best_comparison_pose_prefers_baseline(kk):
    K, Kinv = kk
    P = 8
    qs = np.tile(np.array([1.0, 0, 0, 0], np.float32), (P, 1))
    ts = np.zeros((P, 3), np.float32)
    fids = np.full(P, -1, np.int32)
    valid = np.zeros(P, bool)
    # Slot 0: the reference pf at x=1.0 (newest). Slot 1: zero baseline.
    # Slot 2: good baseline 0.25 m. Slot 3: huge baseline 40 m (overlap
    # gone -> hard reject or tiny overlap).
    for slot, (fid, x) in enumerate([(30, 1.0), (29, 1.0), (28, 0.75),
                                     (27, 41.0)]):
        fids[slot] = fid
        ts[slot, 0] = x
        valid[slot] = True
    q, t, ok = keyframe.best_comparison_pose(
        W, H, jnp.asarray(K, jnp.float32), jnp.asarray(Kinv, jnp.float32),
        jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(fids),
        jnp.asarray(valid), 0, max_pfs=8)
    assert bool(ok)
    # Zero-baseline candidate scores worse (disparity term) than the
    # 0.25 m one; the 40 m one loses overlap entirely.
    assert float(t[0]) == pytest.approx(0.75)


def test_best_comparison_pose_recency_window(kk):
    K, Kinv = kk
    P = 8
    qs = np.tile(np.array([1.0, 0, 0, 0], np.float32), (P, 1))
    ts = np.zeros((P, 3), np.float32)
    fids = np.full(P, -1, np.int32)
    valid = np.zeros(P, bool)
    # Newest candidate (fid 29) has zero baseline; an OLD one (fid 2) has
    # ideal baseline but sits outside the max_pfs=1 recency window.
    for slot, (fid, x) in enumerate([(30, 1.0), (29, 1.0), (2, 0.75)]):
        fids[slot] = fid
        ts[slot, 0] = x
        valid[slot] = True
    q, t, ok = keyframe.best_comparison_pose(
        W, H, jnp.asarray(K, jnp.float32), jnp.asarray(Kinv, jnp.float32),
        jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(fids),
        jnp.asarray(valid), 0, max_pfs=1)
    assert bool(ok)
    assert float(t[0]) == pytest.approx(1.0)  # only fid 29 is in-window


def test_no_candidates_falls_back(kk):
    K, Kinv = kk
    P = 4
    qs = np.tile(np.array([1.0, 0, 0, 0], np.float32), (P, 1))
    ts = np.zeros((P, 3), np.float32)
    fids = np.full(P, -1, np.int32)
    valid = np.zeros(P, bool)
    fids[0] = 5
    valid[0] = True  # only the reference pf itself is resident
    _, _, ok = keyframe.best_comparison_pose(
        W, H, jnp.asarray(K, jnp.float32), jnp.asarray(Kinv, jnp.float32),
        jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(fids),
        jnp.asarray(valid), 0, max_pfs=8)
    assert not bool(ok)


def test_detection_fires_with_degenerate_prev_frame():
    """The current poseframe has near-zero
    baseline to the previous frame, but an older poseframe provides a good
    stereo geometry — detection must still produce insertable winners."""
    from flame_tpu.core import pipeline, frame as frame_mod
    from flame_tpu.params import Params, DetectionParams, SolverParams

    params = Params(
        feature_capacity=256, edge_capacity=1024, triangle_capacity=512,
        poseframe_capacity=4, min_height=-1e6, max_height=1e6,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=5, max_vertex_degree=8))
    K = camera.make_k(FX, FX, W / 2, H / 2)
    Kinv = camera.inv_k(K)

    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    stack = frame_mod.empty_stack(params.poseframe_capacity, H, W,
                                  params.pad)
    # Old poseframe with a solid 0.6 m baseline.
    f_old = frame_mod.create(0, se3.quat_identity(),
                             jnp.array([-0.6, 0.0, 0.0]),
                             jnp.asarray(img), params.pad)
    stack = frame_mod.insert(stack, 0, f_old)
    # Current poseframe at the origin.
    f_pf = frame_mod.create(10, se3.quat_identity(), jnp.zeros(3),
                            jnp.asarray(img), params.pad)
    stack = frame_mod.insert(stack, 1, f_pf)
    # Previous frame: 0.1 mm from the poseframe (degenerate epipole).
    prev_q = se3.quat_identity()
    prev_t = jnp.array([1e-4, 0.0, 0.0])

    feats = pipeline.empty_features(params.feature_capacity)
    fnew = frame_mod.create(11, se3.quat_identity(),
                            jnp.array([0.05, 0.0, 0.0]), jnp.asarray(img),
                            params.pad)
    seed = jnp.full((H, W), jnp.nan)

    def count_winners(p):
        feats2, _, _, _, _, _ = pipeline.track_step(
            p, K, Kinv, stack, feats, fnew, 1, prev_q, prev_t,
            do_detect=True, id_base=0, seed_map=seed)
        return int(np.asarray(feats2.valid).sum())

    n_with = count_winners(params)
    assert n_with > 20, n_with
    # Sanity of the mechanism: with selection disabled the degenerate
    # prev-frame geometry is used directly (epipole on top of the image).
    n_without = count_winners(params.replace(photo_error_num_pfs=0))
    assert n_with >= n_without
