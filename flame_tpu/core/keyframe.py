"""Comparison-poseframe scoring.

Re-design of the reference's KeyFrameSelector::score
(/root/reference/src/flame/utils/keyframe_selector.cc:139-255, adapted
there from MobileFusion): orientation score (cos of relative angle, 60 deg
hard cutoff), view-frustum overlap via convex polygon intersection
(Sutherland-Hodgman replaces Boost.Geometry), and a disparity score
comparing the min-depth test-point disparity to a target maximum.

ONE implementation (score_jax, pure JAX): the device pipeline vmaps it
inside the detection dispatch (best_comparison_pose), and the host
surface — score() for _want_poseframe and the API-parity
KeyframeSelector.select() — is a thin wrapper running the same function
on the CPU backend, once per poseframe and far off the hot path
(reference flame.cc:775-820).
"""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from flame_tpu.geometry import se3


class KeyframeSelector:
    """Pool-managing keyframe selection (reference
    KeyFrameSelector::select, keyframe_selector.cc:73-122; unused by the
    reference's own pipeline, provided for API parity).

    select() returns the index into the pool of the best-scoring keyframe
    for the new pose (-1 when the pool is empty), and adds the new frame
    to the pool when it has moved more than new_kf_thresh from the last
    keyframe (evicting the oldest beyond max_kfs). NOTE: the reference
    decrements the returned index unconditionally after adding a keyframe
    (keyframe_selector.cc:121) even when no eviction shifted the pool; we
    decrement only when the pool actually shifted.
    """

    def __init__(self, K, max_kfs: int = 10, new_kf_thresh: float = 0.1):
        self.K = np.asarray(K, np.float64)
        self.Kinv = np.linalg.inv(self.K)
        self.max_kfs = max_kfs
        self.new_kf_thresh = new_kf_thresh
        self.times: list = []
        self.imgs: list = []
        self.poses: list = []  # (q wxyz, t) camera-to-world

    @staticmethod
    def _relative(q_a, t_a, q_b, t_b):
        """new-to-ref transform: T_a^-1 * T_b as (q, t) numpy."""
        qa = np.asarray(q_a, np.float64)
        w, x, y, z = qa
        R_a = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        qb = np.asarray(q_b, np.float64)
        w2, x2, y2, z2 = qb
        R_b = np.array([
            [1 - 2 * (y2 * y2 + z2 * z2), 2 * (x2 * y2 - w2 * z2),
             2 * (x2 * z2 + w2 * y2)],
            [2 * (x2 * y2 + w2 * z2), 1 - 2 * (x2 * x2 + z2 * z2),
             2 * (y2 * z2 - w2 * x2)],
            [2 * (x2 * z2 - w2 * y2), 2 * (y2 * z2 + w2 * x2),
             1 - 2 * (x2 * x2 + y2 * y2)]])
        R = R_a.T @ R_b
        t = R_a.T @ (np.asarray(t_b, np.float64) - np.asarray(t_a, np.float64))
        # Rotation matrix -> quaternion (wxyz).
        tr = np.trace(R)
        if tr > 0:
            s = 2 * np.sqrt(tr + 1)
            q = np.array([s / 4, (R[2, 1] - R[1, 2]) / s,
                          (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
        else:
            i = int(np.argmax(np.diag(R)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = 2 * np.sqrt(max(1 + R[i, i] - R[j, j] - R[k, k], 1e-12))
            q = np.zeros(4)
            q[0] = (R[k, j] - R[j, k]) / s
            q[1 + i] = s / 4
            q[1 + j] = (R[j, i] + R[i, j]) / s
            q[1 + k] = (R[k, i] + R[i, k]) / s
        return q / np.linalg.norm(q), t

    def select(self, new_time: float, new_img, new_pose) -> int:
        q_new, t_new = new_pose
        h, w = np.asarray(new_img).shape[:2]
        best_idx, best_score = -1, -np.inf
        for i, (q_kf, t_kf) in enumerate(self.poses):
            q_rel, t_rel = self._relative(q_kf, t_kf, q_new, t_new)
            s = score(w, h, self.K, self.Kinv, q_rel, t_rel)
            if s > best_score:
                best_score, best_idx = s, i
        moved = (not self.poses or
                 np.linalg.norm(np.asarray(t_new, np.float64)
                                - np.asarray(self.poses[-1][1], np.float64))
                 > self.new_kf_thresh)
        if moved:
            self.times.append(new_time)
            self.imgs.append(new_img)
            self.poses.append((np.asarray(q_new), np.asarray(t_new)))
            if len(self.times) > self.max_kfs:
                self.times.pop(0)
                self.imgs.pop(0)
                self.poses.pop(0)
                best_idx -= 1
        return best_idx

    def get_keyframe(self, idx: int):
        return self.times[idx], self.imgs[idx], self.poses[idx]


def test_disparity(K: np.ndarray, Kinv: np.ndarray, q_rel: np.ndarray,
                   t_rel: np.ndarray, u_test: np.ndarray,
                   depth: float) -> float:
    """Disparity of a test pixel at the given depth under the relative
    transform (the probe inside score()'s disparity term, reference
    keyframe_selector.cc:222-247). Returns +inf on degenerate geometry."""
    K = np.asarray(K, np.float64)
    Kinv = np.asarray(Kinv, np.float64)
    qw, qx, qy, qz = np.asarray(q_rel, np.float64)
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)]])
    t = np.asarray(t_rel, np.float64)
    u = np.array([u_test[0], u_test[1], 1.0])
    p_inf = K @ (R @ (Kinv @ u))
    p_d = K @ (R @ (depth * (Kinv @ u)) + t)
    if abs(p_inf[2]) < 1e-12 or abs(p_d[2]) < 1e-12:
        return float("inf")
    return float(np.linalg.norm(p_d[:2] / p_d[2] - p_inf[:2] / p_inf[2]))


# ---------------------------------------------------------------------------
# Device-side (JAX) comparison-frame scoring.
#
# The reference's getPoseFrame (flame.cc:775-820) walks backwards through
# up to photo_error_num_pfs poseframes, scores each with
# KeyFrameSelector::score(w, h, K, Kinv, T_pf^-1 * T_new, 1.0, 50.0), and
# hands the winner to detectFeatures as the comparison frame. Running the
# selection on device (fused into the detection dispatch) avoids mirroring
# every poseframe pose to the host — a blocking device->host fetch per
# poseframe.
# ---------------------------------------------------------------------------

_SCORE_LOWEST = float(-np.finfo(np.float32).max)
_CLIP_CAP = 12  # >= 4 corners + one added vertex per rect half-plane clip


def _clip_halfplane(pts, n, d_s, d_p):
    """One Sutherland-Hodgman half-plane clip over fixed-capacity arrays.

    pts: (M, 2) padded subject polygon, n: () live count; d_s/d_p: (M,)
    signed distances (>= 0 inside) of each vertex's predecessor and the
    vertex itself. Returns (pts', n')."""
    M = pts.shape[0]
    idx = jnp.arange(M)
    valid = idx < n
    prev_i = jnp.where(idx == 0, jnp.maximum(n - 1, 0), idx - 1)
    s = pts[prev_i]
    in_s = d_s >= 0
    in_p = d_p >= 0
    denom = d_s - d_p
    safe = jnp.where(jnp.abs(denom) < 1e-12,
                     jnp.where(denom < 0, -1e-12, 1e-12), denom)
    tt = d_s / safe
    inter = s + tt[:, None] * (pts - s)
    # Per subject edge s->p: emit the crossing point, then p when inside.
    emitA = valid & (in_s ^ in_p)
    emitB = valid & in_p
    out_pts = jnp.stack([inter, pts], axis=1).reshape(2 * M, 2)
    emit = jnp.stack([emitA, emitB], axis=1).reshape(2 * M)
    rank = jnp.cumsum(emit) - 1
    res = jnp.zeros((M + 1, 2), pts.dtype).at[
        jnp.where(emit, jnp.minimum(rank, M), M)].set(out_pts, mode="drop")
    return res[:M], jnp.sum(emit.astype(jnp.int32))


def _clip_rect_area(poly4, width, height):
    """Area of a convex quad clipped to [0, width-1] x [0, height-1]."""
    M = _CLIP_CAP
    pts = jnp.zeros((M, 2), jnp.float32).at[:4].set(poly4)
    n = jnp.int32(4)
    for sd in (lambda p: p[:, 0],
               lambda p: (width - 1.0) - p[:, 0],
               lambda p: p[:, 1],
               lambda p: (height - 1.0) - p[:, 1]):
        idx = jnp.arange(M)
        prev_i = jnp.where(idx == 0, jnp.maximum(n - 1, 0), idx - 1)
        pts, n = _clip_halfplane(pts, n, sd(pts[prev_i]), sd(pts))
    idx = jnp.arange(M)
    valid = idx < n
    nxt = jnp.where(idx + 1 >= n, 0, idx + 1)
    t = pts[:, 0] * pts[nxt, 1] - pts[:, 1] * pts[nxt, 0]
    return 0.5 * jnp.abs(jnp.sum(jnp.where(valid, t, 0.0)))


def score_jax(width: int, height: int, K, Kinv, q_rel, t_rel,
              min_depth: float = 1.0, max_depth: float = 50.0,
              max_disparity: float = 100.0):
    """JAX scalar version of score() (vmappable over candidate poseframes).

    q_rel (wxyz) / t_rel: transform taking new-frame coordinates into the
    candidate's frame. Returns the score, or float32 lowest on hard
    rejection — identical decision structure to the host score() above
    (reference keyframe_selector.cc:139-255)."""
    q_rel = jnp.asarray(q_rel, jnp.float32)
    t_rel = jnp.asarray(t_rel, jnp.float32)
    # Full f32 products: a GPU would otherwise run them in TF32.
    hi = jax.lax.Precision.HIGHEST

    # Orientation score with 60-degree hard cutoff.
    w = jnp.clip(jnp.abs(q_rel[0]), 0.0, 1.0)
    s_orient = 0.5 * (jnp.cos(2.0 * jnp.arccos(w)) + 1.0)
    cutoff = 0.5 * (math.cos(math.radians(60.0)) + 1.0)
    ok = s_orient >= cutoff

    # Overlap: project new-image corners at max_depth into the candidate.
    corners = jnp.array([[0.0, 0.0, 1.0], [0.0, height - 1.0, 1.0],
                         [width - 1.0, height - 1.0, 1.0],
                         [width - 1.0, 0.0, 1.0]], jnp.float32)
    rays = jnp.matmul(corners, jnp.asarray(Kinv, jnp.float32).T,
                      precision=hi)
    cam = jax.vmap(lambda r: se3.quat_rotate(q_rel, max_depth * r) + t_rel)(
        rays)
    p = jnp.matmul(cam, jnp.asarray(K, jnp.float32).T, precision=hi)
    ok &= jnp.all(p[:, 2] > 0)
    z = jnp.where(jnp.abs(p[:, 2]) > 1e-12, p[:, 2], 1e-12)
    ref_poly = p[:, :2] / z[:, None]

    # Convexity bail-out (keyframe_selector.cc:194-199).
    e1 = jnp.roll(ref_poly, -1, axis=0) - ref_poly
    e2 = jnp.roll(ref_poly, -2, axis=0) - jnp.roll(ref_poly, -1, axis=0)
    cr = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    ok &= jnp.all(cr >= -1e-9) | jnp.all(cr <= 1e-9)

    # Wind CCW for the half-plane clips.
    nxt = jnp.roll(ref_poly, -1, axis=0)
    signed = 0.5 * jnp.sum(ref_poly[:, 0] * nxt[:, 1]
                           - ref_poly[:, 1] * nxt[:, 0])
    poly = jnp.where(signed >= 0, ref_poly, ref_poly[::-1])
    area = _clip_rect_area(poly, float(width), float(height))
    ok &= area > 0
    s_overlap = area / ((width - 1.0) * (height - 1.0))

    # Disparity of the test point at min vs infinite depth.
    u = jnp.array([width / 4.0, height / 4.0, 1.0], jnp.float32)
    r = jnp.matmul(jnp.asarray(Kinv, jnp.float32), u, precision=hi)
    Kf = jnp.asarray(K, jnp.float32)
    p_inf = jnp.matmul(Kf, se3.quat_rotate(q_rel, r), precision=hi)
    p_min = jnp.matmul(Kf, se3.quat_rotate(q_rel, min_depth * r) + t_rel,
                       precision=hi)
    ok &= (jnp.abs(p_inf[2]) > 1e-12) & (jnp.abs(p_min[2]) > 1e-12)
    pi = p_inf[:2] / jnp.where(jnp.abs(p_inf[2]) > 1e-12, p_inf[2], 1e-12)
    pm = p_min[:2] / jnp.where(jnp.abs(p_min[2]) > 1e-12, p_min[2], 1e-12)
    disparity = jnp.linalg.norm(pm - pi)
    s_disparity = -jnp.abs(1.0 - disparity / max_disparity)

    return jnp.where(ok, s_orient + s_overlap + s_disparity,
                     jnp.float32(_SCORE_LOWEST))


def best_comparison_pose(width: int, height: int, K, Kinv,
                         stack_q, stack_t, stack_fid, stack_valid,
                         ref_slot, max_pfs: int):
    """Device-side getPoseFrame (reference flame.cc:775-820): score the
    max_pfs newest resident poseframes (excluding the reference frame
    itself) against the poseframe at ref_slot and return
    (q_cmp, t_cmp, ok) — ok False when no candidate survives (the caller
    falls back to the previous frame, matching the reference's bootstrap
    fallback at flame.cc:190-210)."""
    q_ref = stack_q[ref_slot]
    t_ref = stack_t[ref_slot]
    q_rel, t_rel = jax.vmap(
        lambda qc, tc: se3.mul(se3.inverse((qc, tc)), (q_ref, t_ref)))(
            stack_q, stack_t)
    scores = jax.vmap(
        lambda qr, tr: score_jax(width, height, K, Kinv, qr, tr))(
            q_rel, t_rel)

    ref_fid = stack_fid[ref_slot]
    cand = stack_valid & (stack_fid != ref_fid) & (stack_fid >= 0)
    # Rank by recency: keep the max_pfs newest candidate frame ids
    # (the reference walks the id-ordered map backwards).
    newer = (stack_fid[None, :] > stack_fid[:, None]) & cand[None, :]
    recency_rank = jnp.sum(newer & cand[:, None], axis=1)
    cand &= recency_rank < max_pfs

    masked = jnp.where(cand, scores, jnp.float32(_SCORE_LOWEST))
    best = jnp.argmax(masked)
    ok = cand.any() & (masked[best] > _SCORE_LOWEST / 2)
    return stack_q[best], stack_t[best], ok


_score_cpu_cache = {}


def _score_cpu(width: int, height: int):
    """CPU-jitted score_jax, cached per image size (host callers)."""
    key = (width, height)
    if key not in _score_cpu_cache:
        _score_cpu_cache[key] = jax.jit(
            functools.partial(score_jax, width, height))
    return _score_cpu_cache[key]


def score(width: int, height: int, K: np.ndarray, Kinv: np.ndarray,
          q_new_to_ref: np.ndarray, t_new_to_ref: np.ndarray,
          min_depth: float = 1.0, max_depth: float = 50.0,
          max_disparity: float = 100.0) -> float:
    """Score a candidate reference poseframe for stereo against a new frame.

    q_new_to_ref (wxyz) / t_new_to_ref: transform taking new-frame
    coordinates into the candidate's frame. Higher is better;
    -inf (float lowest) for hard rejections.

    Host wrapper over the single JAX implementation (score_jax), run on
    the host CPU backend — the previous separate f64 numpy implementation
    was a drift risk the r3 review flagged (the two were parity-tested to
    2e-3; now they cannot diverge). Host callers (_want_poseframe once per
    frame, the API-parity KeyframeSelector.select) are far off the hot
    path; one cached CPU-jit dispatch is ~50 us.
    """
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        s = float(_score_cpu(width, height)(
            jnp.asarray(K, jnp.float32), jnp.asarray(Kinv, jnp.float32),
            jnp.asarray(q_new_to_ref, jnp.float32),
            jnp.asarray(t_new_to_ref, jnp.float32),
            min_depth, max_depth, max_disparity))
    # score_jax's sentinel is float32 lowest; callers' hard-rejection
    # convention compares against -float32max / 2 either way.
    return s
