"""Inverse-depth measurement model (LSD-SLAM noise model), batched.

JAX re-design of the reference's InverseDepthMeasModel
(/root/reference/src/flame/stereo/inverse_depth_meas_model.cc:49-156):
converts a pixel correspondence (u_ref, u_cmp) into an inverse-depth
measurement (mu, var) where var combines geometric epipolar-line noise
(epipolar_line_var / (epi . n_grad)^2) and photometric noise
(2 * pixel_var / (epi . grad)^2), scaled by the local disparity->idepth
slope alpha. Failure cases (negative disparity/idepth, no gradient,
epi orthogonal to gradient) return mu=0, var=1e10 with ok=False, exactly
like the reference.

All coordinates are unpadded image coordinates; gradients are sampled from
the unpadded gradient images (the reference's pad-then-offset dance,
inverse_depth_meas_model.cc:87-93, cancels to exactly this).
"""

import jax
import jax.numpy as jnp

from flame_tpu.geometry import epipolar
from flame_tpu.ops import interp
from flame_tpu.params import MeasModelParams


def _noise_model(params: MeasModelParams, d2i, u_ref, u_inf, epi,
                 disp, mu, gx, gy):
    """The shared LSD-SLAM variance model given a correspondence's
    disparity geometry and the sampled comparison-image gradient.

    d2i: callable (u_ref, u_inf, epi, disp) -> idepth for the +/-10%
    finite-difference alpha slope (the per-frame and stacked variants
    differ only in how their geometry batch is threaded). ONE definition
    of the gates/variances — the two entry points below must never
    diverge. Returns (ok, mu, var).
    """
    bad_disp = disp < 1e-3
    bad_mu = mu < 0.0

    gnorm = jnp.sqrt(gx * gx + gy * gy)
    bad_grad = gnorm < 1e-3
    safe_gnorm = jnp.where(bad_grad, 1.0, gnorm)

    # Geometric disparity variance (unit-gradient projection).
    epi_dot_ngrad = (gx * epi[..., 0] + gy * epi[..., 1]) / safe_gnorm
    bad_epigrad = jnp.abs(epi_dot_ngrad) < 1e-3
    safe_edn = jnp.where(bad_epigrad, 1.0, epi_dot_ngrad)
    geo_var = params.epipolar_line_var / (safe_edn * safe_edn)

    # Photometric disparity variance.
    epi_dot_grad = gx * epi[..., 0] + gy * epi[..., 1]
    safe_edg = jnp.where(jnp.abs(epi_dot_grad) > 0, epi_dot_grad, 1.0)
    photo_var = 2.0 * params.pixel_var / (safe_edg * safe_edg)

    # Disparity -> idepth slope via +/-10% finite difference
    # (inverse_depth_meas_model.cc:133-139).
    disp_min = disp - disp / 10.0
    disp_max = disp + disp / 10.0
    id_min = d2i(u_ref, u_inf, epi, disp_min)
    id_max = d2i(u_ref, u_inf, epi, disp_max)
    denom = jnp.where(jnp.abs(disp_max - disp_min) > 0,
                      disp_max - disp_min, 1.0)
    alpha = (id_max - id_min) / denom

    var = alpha * alpha * (geo_var + photo_var)

    ok = ~(bad_disp | bad_mu | bad_grad | bad_epigrad)
    return ok, jnp.where(ok, mu, 0.0), jnp.where(ok, var, 1e10)


def idepth_measurement(params: MeasModelParams, geo: epipolar.EpiGeo,
                       gradx_cmp: jax.Array, grady_cmp: jax.Array,
                       u_ref: jax.Array, u_cmp: jax.Array):
    """Batched measurement: u_ref, u_cmp are (..., 2).

    Returns (ok, mu, var).
    """
    disp, u_inf, epi = epipolar.disparity(geo, u_ref, u_cmp)
    mu = epipolar.disparity_to_idepth(geo, u_ref, u_inf, epi, disp)
    gx = interp.bilinear(gradx_cmp, u_cmp[..., 0], u_cmp[..., 1])
    gy = interp.bilinear(grady_cmp, u_cmp[..., 0], u_cmp[..., 1])

    def d2i(ur, ui, ep, d):
        return epipolar.disparity_to_idepth(geo, ur, ui, ep, d)

    return _noise_model(params, d2i, u_ref, u_inf, epi, disp, mu, gx, gy)


def idepth_measurement_stacked(params: MeasModelParams, geo_batch,
                               gradx_stack: jax.Array, grady_stack: jax.Array,
                               frame_idx: jax.Array,
                               u_ref: jax.Array, u_cmp: jax.Array):
    """Variant for per-feature geometries and stacked comparison-gradient
    images: geo_batch is an EpiGeo with leading batch dim N; gradients are
    (F, H, W) selected per feature by frame_idx.

    In the full pipeline the *comparison* frame is the single new frame, so
    prefer idepth_measurement; this variant exists for multi-frame batch
    evaluation (e.g. BA residual weighting).
    """
    def single(geo, fidx, ur, uc):
        disp, u_inf, epi = epipolar.disparity(geo, ur, uc)
        mu = epipolar.disparity_to_idepth(geo, ur, u_inf, epi, disp)
        gx = interp.bilinear_stack(gradx_stack, fidx, uc[..., 0], uc[..., 1])
        gy = interp.bilinear_stack(grady_stack, fidx, uc[..., 0], uc[..., 1])
        return disp, mu, epi, gx, gy, u_inf

    disp, mu, epi, gx, gy, u_inf = jax.vmap(single)(
        geo_batch, frame_idx, u_ref, u_cmp)

    def d2i(ur, ui, ep, d):
        return jax.vmap(epipolar.disparity_to_idepth)(geo_batch, ur, ui,
                                                      ep, d)

    return _noise_model(params, d2i, u_ref, u_inf, epi, disp, mu, gx, gy)
