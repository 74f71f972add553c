"""Batched LSD-SLAM-style inverse-depth filtering.

JAX re-design of the reference's per-feature recursive Bayesian
filter (/root/reference/src/flame/stereo/inverse_depth_filter.cc): predict
(reproject mean + (mu'/mu)^4 variance inflation), +/-sigma epipolar
search-region construction with Liang-Barsky clipping and length clamps,
patch search dispatch, and Gaussian fusion with a chi^2 outlier gate.

Every function is total over fixed-size feature batches: the reference's
early-return bools become per-feature validity masks. Status codes match
the reference enum (inverse_depth_filter.h:38-43).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from flame_tpu.geometry import epipolar
from flame_tpu.ops import clipping, interp
from flame_tpu.params import FilterParams
from flame_tpu.stereo import line_stereo

# Status codes (reference inverse_depth_filter.h:38-43).
SUCCESS = 0
FAIL_REF_PATCH_GRADIENT = 1
FAIL_AMBIGUOUS_MATCH = 2
FAIL_MAX_COST = 3


def predict(geo: epipolar.EpiGeo, process_var_factor: float,
            u_ref: jax.Array, mu: jax.Array, var: jax.Array):
    """Project feature means into the comparison frame and inflate variance
    (reference inverse_depth_filter.cc:35-63).

    Returns (ok, u_cmp, mu_pred, var_pred); failed lanes (behind camera)
    get mu_pred=0, var_pred=1e10 like the reference.
    """
    u_cmp, mu_pred = epipolar.project_idepth(geo, u_ref, mu)
    behind = mu_pred < 0.0

    # (mu'/mu)^4 variance inflation; guard mu ~ 0 -> factor 1.
    ratio = mu_pred / jnp.where(jnp.abs(mu) > 0, mu, 1.0)
    var_factor4 = ratio ** 4
    var_factor4 = jnp.where(mu < 1e-6, 1.0, var_factor4)
    var_pred = process_var_factor * var_factor4 * var

    mu_pred = jnp.where(behind, 0.0, mu_pred)
    var_pred = jnp.where(behind, 1e10, var_pred)
    return ~behind, u_cmp, mu_pred, var_pred


class SearchRegion(NamedTuple):
    ok: jax.Array  # (N,) bool
    start: jax.Array  # (N, 2)
    end: jax.Array  # (N, 2)
    epi: jax.Array  # (N, 2) unit direction


def get_search_region(params: FilterParams, geo: epipolar.EpiGeo,
                      width: int, height: int, u_ref: jax.Array,
                      mu_prior: jax.Array, var_prior: jax.Array) -> SearchRegion:
    """Construct the +/- search_sigma epipolar search segment, clipped to the
    1px-border valid region with epilength min-padding / max-clamping
    (reference inverse_depth_filter.cc:65-182)."""
    sigma = jnp.sqrt(jnp.maximum(var_prior, 0.0))
    has_prior = ~(jnp.isnan(mu_prior) | jnp.isnan(var_prior))
    id_min = jnp.where(has_prior, mu_prior - params.search_sigma * sigma,
                       params.idepth_min)
    id_max = jnp.where(has_prior, mu_prior + params.search_sigma * sigma,
                       params.idepth_max)
    id_min = jnp.maximum(id_min, params.idepth_min)
    id_max = jnp.minimum(id_max, params.idepth_max)
    ok = id_max >= id_min

    start, _ = epipolar.project_idepth(geo, u_ref, id_min)
    end, _ = epipolar.project_idepth(geo, u_ref, id_max)

    diff = end - start
    epilength = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    ok = ok & (epilength > 0)
    epi = diff / jnp.maximum(epilength, 1e-12)[..., None]

    # Clip to valid region (1px border; box [1, w-2] x [1, h-2]).
    xmin, xmax = 1.0, float(width - 1)  # tl=(1,1), br=(w-1, h-1) inclusive
    ymin, ymax = 1.0, float(height - 1)
    cv, sx, sy, ex, ey = clipping.clip_line(
        xmin, xmax, ymin, ymax,
        start[..., 0], start[..., 1], end[..., 0], end[..., 1])
    ok = ok & cv
    start = jnp.stack([sx, sy], axis=-1)
    end = jnp.stack([ex, ey], axis=-1)

    diff = end - start
    epilength = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    ok = ok & (epilength > 0)

    # Pad to min length (centered), clamp to max length (clip near end).
    pad = jnp.maximum((params.epilength_min - epilength) / 2.0, 0.0)
    start = start - pad[..., None] * epi
    end = end + pad[..., None] * epi
    too_long = epilength > params.epilength_max
    end = jnp.where(too_long[..., None],
                    start + params.epilength_max * epi, end)

    # Re-clip after padding/clamping.
    cv, sx, sy, ex, ey = clipping.clip_line(
        xmin, xmax, ymin, ymax,
        start[..., 0], start[..., 1], end[..., 0], end[..., 1])
    ok = ok & cv
    start = jnp.stack([sx, sy], axis=-1)
    end = jnp.stack([ex, ey], axis=-1)

    return SearchRegion(ok=ok, start=start, end=end, epi=epi)


class SearchResult(NamedTuple):
    status: jax.Array  # (N,) int32, inverse_depth_filter status codes
    u_cmp: jax.Array  # (N, 2) match position in img_cmp (padded coords)
    residual: jax.Array  # (N,)


def _patch_positions(epi_ref, rescale_factor, u_ref_padded):
    """5-tap reference-patch sample positions at
    u_ref_padded + j * epi_ref * rescale, j in [-2..2]."""
    taps = jnp.arange(-2.0, 3.0)  # (5,)
    off = taps[None, :, None] * (epi_ref * rescale_factor[:, None])[:, None, :]
    return u_ref_padded[:, None, :] + off  # (N, 5, 2)


def _gate_and_match(params: FilterParams, ref_patch, img_cmp, u_start,
                    u_end, rescale_factor, n_steps: int) -> SearchResult:
    """Patch-gradient gate + line-stereo match + status-code mapping —
    ONE definition shared by search/search_stacked (the two paths must
    map failures identically)."""
    grads = jnp.abs(ref_patch[:, 1:] - ref_patch[:, :-1])
    ref_grad_ok = jnp.max(grads, axis=-1) >= params.min_grad_mag

    m = line_stereo.match(ref_patch, img_cmp, u_start, u_end,
                          rescale_factor, params.sparams, n_steps)

    status = jnp.where(
        ~ref_grad_ok, FAIL_REF_PATCH_GRADIENT,
        jnp.where(m.status == line_stereo.FAIL_AMBIGUOUS_MATCH,
                  FAIL_AMBIGUOUS_MATCH,
                  jnp.where(m.status == line_stereo.FAIL_MAX_COST,
                            FAIL_MAX_COST, SUCCESS)))
    return SearchResult(status=status.astype(jnp.int32), u_cmp=m.u_cmp,
                        residual=m.residual)


def search(params: FilterParams, geo: epipolar.EpiGeo,
           rescale_factor: jax.Array,
           img_ref: jax.Array, img_cmp: jax.Array,
           u_ref: jax.Array, u_ref_padded: jax.Array,
           u_start: jax.Array, u_end: jax.Array,
           n_steps: int) -> SearchResult:
    """Sample the 5-tap reference patch along the reference epiline, gate on
    patch gradient, and run the line-stereo match
    (reference inverse_depth_filter.cc:184-266).

    img_ref may be a (H, W) image or a (F, H, W) stack; in the stacked case
    u_ref_padded must carry a leading frame index via ref_frame_idx.
    u_start/u_end are in padded img_cmp coordinates. u_ref (unpadded) is
    used for the reference epiline direction; the reference passes padded
    coordinates here (flame.cc:1693), a small bias we do not reproduce.
    """
    epi_ref = epipolar.reference_epiline(geo, u_ref)  # (N, 2)
    ppos = _patch_positions(epi_ref, rescale_factor, u_ref_padded)
    ref_patch = interp.bilinear(img_ref, ppos[..., 0], ppos[..., 1])
    return _gate_and_match(params, ref_patch, img_cmp, u_start, u_end,
                           rescale_factor, n_steps)


def search_stacked(params: FilterParams, geo_batch,
                   rescale_factor: jax.Array,
                   imgs_ref: jax.Array, ref_frame_idx: jax.Array,
                   img_cmp: jax.Array,
                   u_ref: jax.Array, u_ref_padded: jax.Array,
                   u_start: jax.Array, u_end: jax.Array,
                   n_steps: int, imgs_pack: jax.Array = None) -> SearchResult:
    """search() where each feature samples its own anchor poseframe from an
    image stack (F, H, W) and has its own epipolar geometry (a batch of
    EpiGeo with leading dim N). Used by the full pipeline where features
    are anchored in different poseframes (reference flame.cc:1307-1332).

    imgs_pack: optional persistent packed-corner table of imgs_ref
    (FrameStack.img_pack). When given, the 5-tap ref-patch sampling is one
    row gather against it instead of a 4-corner element gather into the
    20 MB stack.
    """
    epi_ref = jax.vmap(epipolar.reference_epiline)(
        geo_batch, u_ref)  # (N, 2)
    ppos = _patch_positions(epi_ref, rescale_factor, u_ref_padded)
    fidx = ref_frame_idx[:, None].repeat(5, axis=1)
    ref_patch = interp.bilinear_stack(imgs_ref, fidx,
                                      ppos[..., 0], ppos[..., 1],
                                      img_pack=imgs_pack)
    return _gate_and_match(params, ref_patch, img_cmp, u_start, u_end,
                           rescale_factor, n_steps)


def update(mu_pred: jax.Array, var_pred: jax.Array,
           mu_meas: jax.Array, var_meas: jax.Array,
           outlier_sigma_thresh: float = 2.0):
    """Gaussian fusion with chi^2 outlier gating
    (reference inverse_depth_filter.cc:268-305).

    Returns (ok, mu_post, var_post). Lanes where the prediction is invalid
    (NaN or <= 0) take the raw measurement. The chi^2 gate compares the
    residual against the *predicted* variance.
    """
    w = var_pred + var_meas
    safe_w = jnp.where(w > 0, w, 1.0)
    mu_fused = (var_meas * mu_pred + var_pred * mu_meas) / safe_w
    var_fused = (var_pred * var_meas) / safe_w

    first = jnp.isnan(mu_pred) | (mu_pred <= 0.0)
    mu_post = jnp.where(first, mu_meas, mu_fused)
    var_post = jnp.where(first, var_meas, var_fused)

    res = mu_meas - mu_pred
    dist = res * res / jnp.where(var_pred > 0, var_pred, 1e-24)
    # Reference semantics (inverse_depth_filter.cc:283-294): REJECT only
    # when dist > thresh^2. An invalid (NaN) prior makes the C++
    # comparison false -> the measurement is ACCEPTED (first-detection
    # lanes take the raw measurement above); `dist <= t` would invert
    # that for NaN.
    ok = first | ~(dist > outlier_sigma_thresh * outlier_sigma_thresh)

    mu_post = jnp.maximum(mu_post, 0.0)
    return ok, mu_post, var_post
