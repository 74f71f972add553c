"""Gradient-grid feature detection as a dense device computation.

JAX re-design of the reference's single-pass grid detector
(/root/reference/src/flame/flame.cc:1192-1262): instead of a per-pixel
loop, the epipolar-projected gradient score is computed for the whole
image at once (the reference-epiline direction is an affine function of
pixel position, stereo/epipolar_geometry.h:311-331), masked by the border
and the gradient-magnitude threshold, and reduced per detection cell with
a reshape+argmax.

NOTE: the reference queries referenceEpiline(Point2f(ii, jj)) with
(row, col) — a swapped-coordinate bug. We evaluate at the true (x, y).

Slot assignment for winners is host-side (core/flame.py): argmax winners
with unoccupied cells become new features in free slots.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from flame_tpu.geometry import epipolar


class DetectionResult(NamedTuple):
    best_xy: jax.Array  # (Cy, Cx, 2) best pixel per cell
    best_score: jax.Array  # (Cy, Cx) epipolar gradient^2 (0 = none)
    score_map: jax.Array  # (H, W) per-pixel |epigrad| (NaN where masked)


@functools.partial(jax.jit, static_argnames=("win_size", "border",
                                             "row_offset"))
def detect(geo_ref_to_prev: epipolar.EpiGeo, gradx: jax.Array,
           grady: jax.Array, min_grad_mag: float, win_size: int,
           border: int, row_offset: int = 0) -> DetectionResult:
    """Per-cell best epipolar-gradient pixel.

    geo_ref_to_prev: epipolar geometry from the detection (reference) frame
    to the previous frame (reference flame.cc:1206-1209).
    """
    H, W = gradx.shape
    thresh2 = min_grad_mag * min_grad_mag

    ys = jnp.arange(H, dtype=jnp.float32)
    xs = jnp.arange(W, dtype=jnp.float32)
    xx, yy = jnp.meshgrid(xs, ys)

    # Dense reference epiline direction (affine in pixel coords).
    tz = geo_ref_to_prev.t_cmp_to_ref[2]
    K = geo_ref_to_prev.K
    ex = -K[0, 0] * geo_ref_to_prev.t_cmp_to_ref[0] + tz * (xx - K[0, 2])
    ey = -K[1, 1] * geo_ref_to_prev.t_cmp_to_ref[1] + tz * (yy - K[1, 2])
    en = jnp.sqrt(jnp.maximum(ex * ex + ey * ey, 1e-24))
    ex = ex / en
    ey = ey / en

    gmag2 = gradx * gradx + grady * grady
    epigrad = gradx * ex + grady * ey
    epigrad2 = epigrad * epigrad

    in_border = ((xx >= border) & (xx < W - border)
                 & (yy >= border + row_offset)
                 & (yy < H - border - row_offset))
    ok = in_border & (gmag2 >= thresh2) & (epigrad2 >= thresh2)

    score = jnp.where(ok, epigrad2, 0.0)
    score_map = jnp.where(ok, jnp.abs(epigrad), jnp.nan)

    # Pad to cell multiples and reduce per cell.
    Cy = -(-H // win_size)
    Cx = -(-W // win_size)
    ph, pw = Cy * win_size - H, Cx * win_size - W
    score_p = jnp.pad(score, ((0, ph), (0, pw)))
    cells = score_p.reshape(Cy, win_size, Cx, win_size).transpose(0, 2, 1, 3)
    cells = cells.reshape(Cy, Cx, win_size * win_size)
    best = jnp.argmax(cells, axis=-1)
    best_score = jnp.take_along_axis(cells, best[..., None], axis=-1)[..., 0]

    by = best // win_size + jnp.arange(Cy)[:, None] * win_size
    bx = best % win_size + jnp.arange(Cx)[None, :] * win_size
    best_xy = jnp.stack([bx, by], axis=-1).astype(jnp.float32)

    return DetectionResult(best_xy=best_xy, best_score=best_score,
                           score_map=score_map)


@functools.partial(jax.jit, static_argnames=("win_size", "border",
                                             "row_offset"))
def detect_packed(geo_ref_to_prev: epipolar.EpiGeo, gradx: jax.Array,
                  grady: jax.Array, feat_xy: jax.Array,
                  feat_valid: jax.Array, min_grad_mag: float, win_size: int,
                  border: int, row_offset: int = 0) -> jax.Array:
    """detect() + occupied-cell masking fused into one dispatch whose
    output is a single (Cy*Cx, 3) array [x, y, take] — one transfer for
    the host's slot assignment."""
    H, W = gradx.shape
    res = detect(geo_ref_to_prev, gradx, grady, min_grad_mag, win_size,
                 border, row_offset)
    cy = res.best_score.shape[0]
    cx = res.best_score.shape[1]
    occ = occupied_cells(feat_xy, feat_valid, win_size, cy, cx)
    take = (res.best_score > 0) & ~occ
    out = jnp.concatenate([res.best_xy.reshape(-1, 2),
                           take.reshape(-1, 1).astype(jnp.float32)], axis=1)
    return out


@functools.partial(jax.jit, static_argnames=("win_size", "n_cells_y",
                                             "n_cells_x"))
def occupied_cells(feat_xy: jax.Array, feat_valid: jax.Array, win_size: int,
                   n_cells_y: int, n_cells_x: int) -> jax.Array:
    """Mask of detection cells already holding a feature
    (reference flame.cc:1194-1204). feat_xy in the detection frame."""
    cx = jnp.clip((feat_xy[:, 0] // win_size).astype(jnp.int32), 0,
                  n_cells_x - 1)
    cy = jnp.clip((feat_xy[:, 1] // win_size).astype(jnp.int32), 0,
                  n_cells_y - 1)
    flat = cy * n_cells_x + cx
    occ = jax.ops.segment_sum(feat_valid.astype(jnp.int32), flat,
                              num_segments=n_cells_y * n_cells_x)
    return (occ > 0).reshape(n_cells_y, n_cells_x)
