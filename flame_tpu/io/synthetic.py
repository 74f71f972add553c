"""Deterministic miniature TUM-format dataset with realistic imagery.

The reference repo validated end-to-end behavior on real TUM/EuRoC
sequences downstream in flame_ros (README.md:84-85); nothing ships in
either repo. This module generates a small but *structured* posed
monocular sequence on disk in exact TUM RGB-D layout (rgb/ + rgb.txt +
groundtruth.txt) so the whole dataset path — loader, associator,
orchestrator, evaluation — runs end-to-end with known ground truth:

  * Scene: a textured corridor (floor, ceiling, two side walls, back
    wall) ray-cast per pixel; depth spans ~1.5-8 m with perspective
    foreshortening and a depth discontinuity at every wall junction.
  * Texture: multi-octave value noise (approximately 1/f power spectrum,
    the classic natural-image statistic) — NOT a sine board; gradient
    distribution and matchability resemble real indoor footage.
  * Trajectory: forward motion with lateral sway and slow yaw, so both
    translation directions and rotation exercise the epipolar search.

Everything derives from an integer seed; a regression test can re-create
the byte-identical sequence instead of checking binaries into the repo.
"""

import os
from typing import List, Optional, Tuple

import numpy as np

# Scene extents (meters, camera convention: +x right, +y down, +z fwd).
_FLOOR_Y = 0.9
_CEIL_Y = -0.9
_LEFT_X = -1.6
_RIGHT_X = 1.6
_BACK_Z = 9.0


def _lattice(seed: int, n: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, n))


def _value_noise(lat: np.ndarray, u: np.ndarray, v: np.ndarray
                 ) -> np.ndarray:
    """Bilinear wraparound sample of a random lattice."""
    n = lat.shape[0]
    u = np.mod(u, n)
    v = np.mod(v, n)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = u - u0
    fv = v - v0
    u0 = np.mod(u0, n)
    v0 = np.mod(v0, n)
    u1 = np.mod(u0 + 1, n)
    v1 = np.mod(v0 + 1, n)
    # Smoothstep for C1 continuity (gradients exist everywhere).
    fu = fu * fu * (3 - 2 * fu)
    fv = fv * fv * (3 - 2 * fv)
    a = lat[v0, u0] * (1 - fu) + lat[v0, u1] * fu
    b = lat[v1, u0] * (1 - fu) + lat[v1, u1] * fu
    return a * (1 - fv) + b * fv


def _fractal_texture(u: np.ndarray, v: np.ndarray, seed: int,
                     octaves: int = 5, base_scale: float = 3.0
                     ) -> np.ndarray:
    """Multi-octave value noise in [0, 255] with ~1/f spectrum."""
    out = np.zeros_like(u, dtype=np.float64)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        lat = _lattice(seed * 31 + o)
        s = base_scale * (2.0 ** o)
        out += amp * _value_noise(lat, u * s, v * s)
        total += amp
        amp *= 0.55
    out /= total
    return np.clip(128 + 120 * out, 0, 255)


def trajectory(i: int) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth camera-to-world pose of frame i (q wxyz, t)."""
    yaw = 0.04 * np.sin(i / 9.0)
    q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
    t = np.array([0.35 * np.sin(i / 6.0), 0.08 * np.sin(i / 11.0),
                  0.11 * i])
    return q, t


# Occluding box (with_box=True): a free-standing obstacle in the
# corridor. Its front face sits ~3.4 m from the start of the trajectory,
# creating a genuine depth DISCONTINUITY against the side/back walls
# (2-5 m behind it) and genuinely occluded epipolar matches as the
# camera translates past it — the pathologies the reference's chi^2
# outlier gate (inverse_depth_filter.cc:268-305), dropout counters and
# oblique-triangle filter (flame.cc:2207-2283) exist for.
_BOX_X = (-0.75, -0.05)
_BOX_Y = (-0.15, _FLOOR_Y)  # stands on the floor
_BOX_Z = (3.4, 4.2)

# Texture pathologies — the two classic monocular
# failure modes the reference's gates exist for:
#   * A TEXTURE-FREE patch on the right wall (with_flat_patch): constant
#     intensity, zero gradient — the detection grid must yield no
#     features there (reference detection threshold, flame.cc:1216-1251)
#     and the mesh must interpolate across, not hallucinate.
# (The repetitive-texture pathology — the second classic failure mode —
# is exercised by tests/test_nonideal.py's dedicated picket-fence plane
# scene: a fronto-parallel striped plane under lateral translation puts
# the periodicity exactly along the epipolar search, which the corridor
# geometry cannot do cleanly — its walls foreshorten any periodic band
# into a chirp and its back wall is too small in view.)
_FLAT_PATCH_Y = (-0.55, 0.55)  # on the right wall (x = _RIGHT_X)
_FLAT_PATCH_Z = (2.6, 6.4)


def render_frame(K: np.ndarray, q: np.ndarray, t: np.ndarray,
                 width: int, height: int, seed: int = 7,
                 with_box: bool = False,
                 with_flat_patch: bool = False,
                 exposure_gain: float = 1.0,
                 exposure_bias: float = 0.0,
                 noise_sigma: float = 0.0,
                 noise_rng: Optional[np.random.Generator] = None,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast the corridor. Returns (uint8 image, float32 idepth map).

    with_box adds the occluding box; with_flat_patch blanks a patch of
    the right wall to constant intensity (zero gradient); exposure_gain/bias
    model per-frame photometric drift (applied before quantization);
    noise_sigma adds i.i.d. Gaussian sensor noise (intensity units,
    needs noise_rng)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
    d = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)],
                 axis=-1)  # camera-frame ray dirs, (H, W, 3)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    dw = d @ R.T  # world-frame directions
    o = np.asarray(t, np.float64)

    best_t = np.full((height, width), np.inf)
    val = np.zeros((height, width))

    def hit(axis, plane, tex_axes, tseed, bounds=None, tex_override=None):
        """Intersect rays with a bounded axis-aligned plane. bounds:
        {axis: (lo, hi)} limits for the non-plane axes (default: the
        corridor extents). tex_override(pt, tex) -> tex' applies a
        texture pathology over part of the face (flat patch / stripes)."""
        nonlocal best_t, val
        if bounds is None:
            bounds = {0: (_LEFT_X - 1e-6, _RIGHT_X + 1e-6),
                      1: (_CEIL_Y - 1e-6, _FLOOR_Y + 1e-6),
                      2: (-np.inf, _BACK_Z + 1e-6)}
        denom = dw[..., axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            th = (plane - o[axis]) / denom
        ok = (th > 0.05) & np.isfinite(th)
        # Mask before multiplying: inf/nan ray parameters on rays parallel
        # to the plane would otherwise emit RuntimeWarnings (inf * 0).
        th_safe = np.where(ok, th, 1.0)
        pt = o[None, None, :] + th_safe[..., None] * dw
        for ax, (lo, hi) in bounds.items():
            if ax != axis:
                ok &= (pt[..., ax] >= lo) & (pt[..., ax] <= hi)
        ok &= th < best_t
        a, b = tex_axes
        tex = _fractal_texture(
            np.nan_to_num(pt[..., a], posinf=0.0, neginf=0.0),
            np.nan_to_num(pt[..., b], posinf=0.0, neginf=0.0), tseed)
        if tex_override is not None:
            tex = tex_override(pt, tex)
        best_t = np.where(ok, th, best_t)
        val = np.where(ok, tex, val)

    def flat_override(pt, tex):
        inside = ((pt[..., 1] >= _FLAT_PATCH_Y[0])
                  & (pt[..., 1] <= _FLAT_PATCH_Y[1])
                  & (pt[..., 2] >= _FLAT_PATCH_Z[0])
                  & (pt[..., 2] <= _FLAT_PATCH_Z[1]))
        return np.where(inside, 128.0, tex)

    hit(1, _FLOOR_Y, (0, 2), seed + 1)
    hit(1, _CEIL_Y, (0, 2), seed + 2)
    hit(0, _LEFT_X, (1, 2), seed + 3)
    hit(0, _RIGHT_X, (1, 2), seed + 4,
        tex_override=flat_override if with_flat_patch else None)
    hit(2, _BACK_Z, (0, 1), seed + 5)

    if with_box:
        bb = {0: _BOX_X, 1: _BOX_Y, 2: _BOX_Z}
        # Front/top/side faces (the back face is never the nearest hit).
        hit(2, _BOX_Z[0], (0, 1), seed + 6, bounds=bb)
        hit(1, _BOX_Y[0], (0, 2), seed + 7, bounds=bb)
        hit(0, _BOX_X[0], (1, 2), seed + 8, bounds=bb)
        hit(0, _BOX_X[1], (1, 2), seed + 9, bounds=bb)

    # Camera-frame depth of the hit point (z component). Mask misses
    # (best_t = inf) before the multiply for the same warning reason.
    t_safe = np.where(np.isfinite(best_t), best_t, 1.0)
    hitp = t_safe[..., None] * dw
    z_cam = hitp @ R[:, 2]
    idepth = np.where(np.isfinite(best_t) & (z_cam > 1e-6),
                      1.0 / np.maximum(z_cam, 1e-6), np.nan)
    val = exposure_gain * val + exposure_bias
    if noise_sigma > 0.0:
        if noise_rng is None:
            # A seed-derived fallback would re-seed identically every
            # call, adding the SAME noise field to every frame — frozen
            # fixed-pattern noise that tracking trivially tolerates, so
            # a stress test written that way would silently measure
            # nothing. Require the caller to thread a generator.
            raise ValueError("noise_sigma > 0 requires noise_rng (a "
                             "np.random.Generator advanced across "
                             "frames)")
        val = val + noise_rng.normal(0.0, noise_sigma, val.shape)
    return np.clip(val, 0, 255).astype(np.uint8), idepth.astype(np.float32)


def wall_patch_mask(K: np.ndarray, q: np.ndarray, t: np.ndarray,
                    width: int, height: int, axis: int, plane: float,
                    a_axis: int, a_rng: Tuple[float, float],
                    b_axis: int, b_rng: Tuple[float, float]) -> np.ndarray:
    """Boolean (H, W) mask of pixels whose ray meets the wall plane
    (coordinate `axis` == plane) inside the rectangle given by the two
    other axes — the image footprint of a texture-pathology patch (the
    caller intersects with the truth map's valid region; in the
    box-free corridor the walls are never occluded)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
    d = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)],
                 axis=-1)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    dw = d @ R.T
    o = np.asarray(t, np.float64)
    denom = dw[..., axis]
    with np.errstate(divide="ignore", invalid="ignore"):
        th = (plane - o[axis]) / denom
    ok = (th > 0.05) & np.isfinite(th)
    th_safe = np.where(ok, th, 1.0)
    pt = o[None, None, :] + th_safe[..., None] * dw
    return (ok & (pt[..., a_axis] >= a_rng[0])
            & (pt[..., a_axis] <= a_rng[1])
            & (pt[..., b_axis] >= b_rng[0])
            & (pt[..., b_axis] <= b_rng[1]))


def generate_mini_tum(root: str, n_frames: int = 24, width: int = 256,
                      height: int = 192, fx: float = 210.0,
                      seed: int = 7,
                      pose_noise_t: float = 0.0,
                      pose_noise_deg: float = 0.0,
                      noise_seed: int = 0,
                      with_box: bool = False,
                      exposure_drift: float = 0.0,
                      noise_sigma: float = 0.0) -> dict:
    """Write a TUM-format sequence to `root`.

    groundtruth.txt always holds the TRUE trajectory; when pose_noise_* is
    nonzero a second file noisy.txt holds the perturbed trajectory (the
    input an external odometry would supply), letting BA evaluation
    compare ATE of noisy vs refined poses against ground truth.
    Returns {"K", "gt": [(q, t)], "noisy": [(q, t)] or None}.

    Non-ideal imagery knobs: with_box adds a
    free-standing occluder (depth discontinuity + occluded matches);
    exposure_drift applies a per-frame gain 1 + drift*sin(i/4) and bias
    8*drift*sin(i/3) (slow photometric drift); noise_sigma adds
    per-frame i.i.d. Gaussian sensor noise (deterministic in
    noise_seed).
    """
    from PIL import Image

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    K = np.array([[fx, 0, width / 2.0], [0, fx, height / 2.0], [0, 0, 1]])
    rng = np.random.default_rng(noise_seed)

    gt: List[Tuple[np.ndarray, np.ndarray]] = []
    noisy: Optional[List[Tuple[np.ndarray, np.ndarray]]] = \
        [] if (pose_noise_t or pose_noise_deg) else None
    rgb_lines = []
    gt_lines = []
    noisy_lines = []
    img_rng = np.random.default_rng(noise_seed + 1)
    for i in range(n_frames):
        q, t = trajectory(i)
        img, _ = render_frame(
            K, q, t, width, height, seed, with_box=with_box,
            exposure_gain=1.0 + exposure_drift * np.sin(i / 4.0),
            exposure_bias=8.0 * exposure_drift * np.sin(i / 3.0),
            noise_sigma=noise_sigma, noise_rng=img_rng)
        name = f"rgb/{i:06d}.png"
        Image.fromarray(img, mode="L").save(os.path.join(root, name))
        ts = f"{i * 0.1:.6f}"
        rgb_lines.append(f"{ts} {name}")
        # TUM pose line: tx ty tz qx qy qz qw.
        gt_lines.append(f"{ts} {t[0]} {t[1]} {t[2]} "
                        f"{q[1]} {q[2]} {q[3]} {q[0]}")
        gt.append((q, t))
        if noisy is not None:
            tn = t + rng.normal(0, pose_noise_t, 3)
            ang = np.deg2rad(pose_noise_deg) * rng.normal()
            ax = rng.normal(size=3)
            ax /= np.linalg.norm(ax)
            dq = np.array([np.cos(ang / 2), *(np.sin(ang / 2) * ax)])
            w1, x1, y1, z1 = q
            w2, x2, y2, z2 = dq
            qn = np.array([
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])
            noisy.append((qn, tn))
            noisy_lines.append(f"{ts} {tn[0]} {tn[1]} {tn[2]} "
                               f"{qn[1]} {qn[2]} {qn[3]} {qn[0]}")

    header = "# timestamp data\n"
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write(header + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write(header + "\n".join(gt_lines) + "\n")
    if noisy is not None:
        with open(os.path.join(root, "noisy.txt"), "w") as f:
            f.write(header + "\n".join(noisy_lines) + "\n")
    return {"K": K, "gt": gt, "noisy": noisy}
