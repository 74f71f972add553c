"""Unconstrained 2-D re-matching of BA observations.

The tracking front-end produces matches by searching ALONG the epipolar
line of the (possibly noisy) input poses (stereo/line_stereo.py, after
reference line_stereo.h:75-385). Those matches have zero residual
perpendicular to the epiline BY CONSTRUCTION, so a bundle adjustment fed
with them is nearly blind to the pose error: it can only see what leaks
into the along-line/depth direction (measured: 12 mm injected ATE ->
11.5 mm after BA).

Before each solve, this module re-matches every observation with a small
UNCONSTRAINED 2-D SSD search around the current-estimate prediction,
restoring the perpendicular component of the reprojection residual. The
formulation here samples each observation's (2*(radius+hp)+1)^2 pixel
window ONCE (bilinear row-gathers) and computes the SSD field by shifted
sums — 121 samples/observation instead of 1225 at radius 3, patch 5x5.

Quadratic subpixel refinement and a max-cost + interior-minimum gate
mirror line_stereo's acceptance tests; gated lanes keep their epipolar
match.
"""

import functools

import jax
import jax.numpy as jnp

from flame_tpu.geometry import se3, epipolar
from flame_tpu.ops import interp


@functools.partial(jax.jit, static_argnames=("radius", "hp", "pad"))
def rematch_observations(K, Kinv, imgs_pad, pad: int, qw, tw,
                         anchor_idx, obs_idx, anchor_slot, obs_slot,
                         u_ref, u_obs, lm_idx, lm_idepth, valid,
                         radius: int = 3, hp: int = 2,
                         max_cost: float = 6500.0,
                         min_eig: float = 625.0, img_pack=None):
    """Returns (u_obs_refined (M, 2), refined (M,) bool).

    qw/tw: (P, 4)/(P, 3) window poses (camera-to-world).
    anchor_idx/obs_idx: (M,) indices into the window pose arrays.
    anchor_slot/obs_slot: (M,) poseframe-stack slots for image sampling.
    u_ref/u_obs: (M, 2) unpadded pixels. lm_idepth: (L,) anchor-frame
    inverse depths; lm_idx: (M,) landmark of each observation.
    img_pack: optional FrameStack.img_pack persistent packed-corner
    table; when given, the ~500k window samples are row gathers against
    it instead of rebuilding a full-stack packed table per solve.
    """
    M = u_ref.shape[0]
    Hp, Wp = imgs_pad.shape[1:]
    H, W = Hp - 2 * pad, Wp - 2 * pad

    # Predict each observation's pixel from the current estimates.
    q_rel, t_rel = se3.mul(
        se3.inverse((qw[obs_idx], tw[obs_idx])),
        (qw[anchor_idx], tw[anchor_idx]))
    geos = jax.vmap(epipolar.load, in_axes=(None, None, 0, 0))(
        K, Kinv, q_rel, t_rel)
    u_pred, _ = jax.vmap(epipolar.project_idepth)(
        geos, u_ref, lm_idepth[lm_idx])

    # Window samples around the prediction (observed frame).
    r = radius + hp
    Wn = 2 * r + 1
    offs = jnp.arange(-r, r + 1, dtype=jnp.float32)
    wx = u_pred[:, 0, None, None] + offs[None, None, :] + pad
    wy = u_pred[:, 1, None, None] + offs[None, :, None] + pad
    fobs = jnp.broadcast_to(obs_slot[:, None, None], (M, Wn, Wn))
    # packed=True: ~500k one-off samples from a static stack, one packed
    # row gather per sample instead of 4 corner gathers.
    win = interp.bilinear_stack(imgs_pad, fobs, wx, wy,
                                packed=True, img_pack=img_pack)  # (M,Wn,Wn)

    # Anchor patch at u_ref.
    Pn = 2 * hp + 1
    poffs = jnp.arange(-hp, hp + 1, dtype=jnp.float32)
    px = u_ref[:, 0, None, None] + poffs[None, None, :] + pad
    py = u_ref[:, 1, None, None] + poffs[None, :, None] + pad
    fanc = jnp.broadcast_to(anchor_slot[:, None, None], (M, Pn, Pn))
    patch = interp.bilinear_stack(imgs_pad, fanc, px, py,
                                  packed=True, img_pack=img_pack)  # (M,Pn,Pn)

    # SSD field over candidate centers: costs[(cy, cx)] =
    # sum_patch (win[cy+py, cx+px] - patch[py, px])^2, cy/cx in [0, 2r].
    Cn = 2 * radius + 1
    costs = jnp.zeros((M, Cn, Cn), jnp.float32)
    for dy in range(Pn):
        for dx in range(Pn):
            d = win[:, dy:dy + Cn, dx:dx + Cn] \
                - patch[:, dy:dy + 1, dx:dx + 1]
            costs = costs + d * d

    flat = costs.reshape(M, Cn * Cn)
    best = jnp.argmin(flat, axis=1)
    by = best // Cn
    bx = best % Cn
    cmin = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]

    # Quadratic subpixel in x and y around the (interior) minimum.
    byc = jnp.clip(by, 1, Cn - 2)
    bxc = jnp.clip(bx, 1, Cn - 2)
    ii = jnp.arange(M)

    def at(dy, dx):
        return costs[ii, byc + dy, bxc + dx]

    def parab(cm, c0, cp):
        denom = cm - 2.0 * c0 + cp
        return jnp.where(denom > 1e-12,
                         0.5 * (cm - cp) / jnp.maximum(denom, 1e-12), 0.0)

    sx = jnp.clip(parab(at(0, -1), at(0, 0), at(0, 1)), -0.5, 0.5)
    sy = jnp.clip(parab(at(-1, 0), at(0, 0), at(1, 0)), -0.5, 0.5)

    u_new = jnp.stack([
        u_pred[:, 0] + (bx.astype(jnp.float32) - radius) + sx,
        u_pred[:, 1] + (by.astype(jnp.float32) - radius) + sy], axis=1)

    interior = (by >= 1) & (by <= Cn - 2) & (bx >= 1) & (bx <= Cn - 2)
    in_bounds = ((u_pred[:, 0] >= r) & (u_pred[:, 0] < W - r)
                 & (u_pred[:, 1] >= r) & (u_pred[:, 1] < H - r))

    # Aperture gate (KLT corner criterion): a 2-D match is only trusted
    # where the anchor patch constrains BOTH directions — min eigenvalue
    # of the gradient structure tensor above min_eig. Edge-like patches
    # (the common case on an epipolar-tracked feature set) keep their
    # epipolar match: re-matching them injects perpendicular noise and
    # WORSENS the solve (measured 5x ATE inflation ungated).
    gx = 0.5 * (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2])
    gy = 0.5 * (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1])
    gxx = jnp.sum(gx * gx, axis=(1, 2))
    gyy = jnp.sum(gy * gy, axis=(1, 2))
    gxy = jnp.sum(gx * gy, axis=(1, 2))
    tr = 0.5 * (gxx + gyy)
    det = gxx * gyy - gxy * gxy
    lam_min = tr - jnp.sqrt(jnp.maximum(tr * tr - det, 0.0))
    corner = lam_min >= min_eig

    refined = valid & interior & in_bounds & (cmin <= max_cost) & corner
    u_out = jnp.where(refined[:, None], u_new, u_obs)
    return u_out, refined


@functools.partial(jax.jit, static_argnames=("hp", "pad"))
def observation_weights(imgs_pad, pad: int, anchor_slot, u_ref,
                        hp: int = 2, eps: float = 1e-3, img_pack=None):
    """Per-observation 2x2 residual whitening from the anchor patch's
    gradient structure tensor, sqrtW (M, 2, 2) with W = G / lambda_max.

    An epipolar (or any intensity) match only constrains the
    reprojection along the local gradient: for an edge-like patch
    W -> n n^T (1 DOF, the edge normal), for a corner W -> I (2 DOF).
    Whitening residuals and Jacobians with sqrtW lets BA combine
    many differently-oriented edge features into full pose constraints
    instead of treating their unknown along-edge components as
    measurements.
    """
    M = u_ref.shape[0]
    Pn = 2 * hp + 1
    poffs = jnp.arange(-hp, hp + 1, dtype=jnp.float32)
    px = u_ref[:, 0, None, None] + poffs[None, None, :] + pad
    py = u_ref[:, 1, None, None] + poffs[None, :, None] + pad
    fanc = jnp.broadcast_to(anchor_slot[:, None, None], (M, Pn, Pn))
    patch = interp.bilinear_stack(imgs_pad, fanc, px, py, packed=True,
                                  img_pack=img_pack)

    gx = 0.5 * (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2])
    gy = 0.5 * (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1])
    gxx = jnp.sum(gx * gx, axis=(1, 2))
    gyy = jnp.sum(gy * gy, axis=(1, 2))
    gxy = jnp.sum(gx * gy, axis=(1, 2))
    tr = 0.5 * (gxx + gyy)
    disc = jnp.sqrt(jnp.maximum(tr * tr - (gxx * gyy - gxy * gxy), 0.0))
    lam_max = tr + disc

    s = 1.0 / jnp.maximum(lam_max, 1e-12)
    Wxx = gxx * s
    Wyy = gyy * s
    Wxy = gxy * s
    # Analytic PSD square root of the 2x2 W (eigenvalues in [0, 1]):
    # sqrt(W) = (W + sqrt(det W) I) / sqrt(tr W + 2 sqrt(det W)).
    detw = jnp.maximum(Wxx * Wyy - Wxy * Wxy, 0.0)
    sdet = jnp.sqrt(detw)
    denom = jnp.sqrt(jnp.maximum(Wxx + Wyy + 2.0 * sdet, eps))
    sw = jnp.stack([
        jnp.stack([(Wxx + sdet) / denom, Wxy / denom], axis=-1),
        jnp.stack([Wxy / denom, (Wyy + sdet) / denom], axis=-1),
    ], axis=-2)  # (M, 2, 2)
    return sw
