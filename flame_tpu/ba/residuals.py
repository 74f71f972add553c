"""Reprojection residuals and Jacobian blocks for windowed BA.

New capability vs the reference, which assumes an external pose estimator
and only exposes the updatePoseFramePoses/prunePoseFrames hooks
(/root/reference/src/flame/flame.h:155-174). Here the estimator is
internal: keyframe poses + per-landmark inverse depths are refined by
Gauss-Newton on Huber-weighted reprojection errors.

Parameterization:
  * poses: camera-to-world (q, t) per keyframe, perturbed on the left in
    the world frame: T <- exp(xi) * T.
  * landmarks: scalar inverse depth d anchored at pixel u_ref of an anchor
    keyframe.

Residual for observation (anchor a, observer o, u_ref, u_obs, d):
  r = project(K, T_o^-1 * T_a * backproject(u_ref) / d) - u_obs   (2,)

Jacobian blocks (2, 6) w.r.t. both poses' tangents and (2, 1) w.r.t. d are
computed with forward-mode autodiff, vmapped over observations — exactly
the per-observation sparsity the Schur assembly consumes.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from flame_tpu.geometry import se3


class BAObservations(NamedTuple):
    """Padded observation set [M]."""

    anchor_idx: jax.Array  # (M,) int32 index into window poses
    obs_idx: jax.Array  # (M,) int32 index into window poses
    lm_idx: jax.Array  # (M,) int32 landmark index
    u_ref: jax.Array  # (M, 2)
    u_obs: jax.Array  # (M, 2)
    valid: jax.Array  # (M,) bool


def _residual_single(K, Kinv, q_a, t_a, q_o, t_o, u_ref, d, xi_a, xi_o, dd):
    """Residual with tangent perturbations applied (for autodiff)."""
    qa, ta = se3.mul(se3.exp(xi_a), (q_a, t_a))
    qo, to = se3.mul(se3.exp(xi_o), (q_o, t_o))

    rx = Kinv[0, 0] * u_ref[0] + Kinv[0, 2]
    ry = Kinv[1, 1] * u_ref[1] + Kinv[1, 2]
    ray = jnp.stack([rx, ry, 1.0])
    depth = 1.0 / jnp.maximum(d + dd, 1e-6)
    p_w = se3.act((qa, ta), ray * depth)
    p_o = se3.act(se3.inverse((qo, to)), p_w)
    z = p_o[2]
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    u = jnp.stack([K[0, 0] * p_o[0] / safe_z + K[0, 2],
                   K[1, 1] * p_o[1] / safe_z + K[1, 2]])
    return u, z


def residuals_and_jacobians(K, Kinv, q_w, t_w, obs: BAObservations,
                            lm_idepth, huber_delta: float, sqrtW=None):
    """Batched residuals + Jacobian blocks + robust weights.

    q_w, t_w: (P, 4), (P, 3) window poses. lm_idepth: (L,).
    sqrtW: optional (M, 2, 2) per-observation residual whitening (e.g.
    the structure-tensor weights of ba/rematch.observation_weights) —
    applied to the residual and every Jacobian block so the downstream
    normal-equation assembly is unchanged.
    Returns (r (M, 2), Ja (M, 2, 6), Jo (M, 2, 6), Jd (M, 2), w (M,)).
    Invalid/behind-camera observations get zero weight.
    """
    zeros6 = jnp.zeros(6)

    # jacfwd over the three perturbation args, vmapped over observations.
    def f_full(a_i, o_i, l_i, u_ref, u_obs, xi_a, xi_o, dd):
        q_a, t_a = q_w[a_i], t_w[a_i]
        q_o, t_o = q_w[o_i], t_w[o_i]
        d = lm_idepth[l_i]
        u, z = _residual_single(K, Kinv, q_a, t_a, q_o, t_o, u_ref, d,
                                xi_a, xi_o, dd)
        return u - u_obs, z

    def one(a_i, o_i, l_i, u_ref, u_obs, valid, L2):
        g = lambda xi_a, xi_o, dd: f_full(a_i, o_i, l_i, u_ref, u_obs,
                                          xi_a, xi_o, dd)
        (r, z) = g(zeros6, zeros6, 0.0)
        Ja, Jo, Jd = jax.jacfwd(lambda args: g(*args)[0])(
            (zeros6, zeros6, 0.0))
        if L2 is not None:
            # Full f32 products: a GPU would otherwise run them in TF32.
            hi = jax.lax.Precision.HIGHEST
            r = jnp.matmul(L2, r, precision=hi)
            Ja = jnp.matmul(L2, Ja, precision=hi)
            Jo = jnp.matmul(L2, Jo, precision=hi)
            Jd = jnp.matmul(L2, Jd, precision=hi)
        # Robust (Huber) weight on the residual norm.
        rn = jnp.linalg.norm(r)
        w_h = jnp.where(rn <= huber_delta, 1.0,
                        huber_delta / jnp.maximum(rn, 1e-12))
        ok = valid & (z > 1e-3)
        w = jnp.where(ok, w_h, 0.0)
        return r, Ja, Jo, Jd, w

    in_axes = (0, 0, 0, 0, 0, 0, None if sqrtW is None else 0)
    r, Ja, Jo, Jd, w = jax.vmap(one, in_axes=in_axes)(
        obs.anchor_idx, obs.obs_idx, obs.lm_idx,
        obs.u_ref, obs.u_obs, obs.valid, sqrtW)
    return r, Ja, Jo, Jd, w
