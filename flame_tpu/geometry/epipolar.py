"""Two-view epipolar geometry as a precomputed pytree + batched query functions.

JAX re-design of the reference's EpipolarGeometry<Scalar> class
(/root/reference/src/flame/stereo/epipolar_geometry.h:44-428). Instead of a
stateful C++ object queried pixel-by-pixel, `load(K, Kinv, q, t)` returns an
EpiGeo NamedTuple of cached tensors (KRKinv, Kt, epipole, ...) and every
query function broadcasts over arbitrary batches of pixels, so the whole
per-feature epipolar pipeline vmaps into single fused XLA ops.

Conventions match the reference: the *comparison* camera is the one pixels
are projected onto; depths are defined in the *reference* camera; epilines
point from infinite depth toward minimum depth.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from flame_tpu.geometry import se3


class EpiGeo(NamedTuple):
    """Cached two-view geometry (reference epipolar_geometry.h:415-427)."""

    K: jax.Array  # (3, 3)
    Kinv: jax.Array  # (3, 3)
    q_ref_to_cmp: jax.Array  # (4,) wxyz
    t_ref_to_cmp: jax.Array  # (3,)
    t_cmp_to_ref: jax.Array  # (3,)
    KRKinv: jax.Array  # (3, 3)
    Kt: jax.Array  # (3,)
    epipole: jax.Array  # (2,) valid when t_ref_to_cmp[2] > 0


def load(K: jax.Array, Kinv: jax.Array, q_ref_to_cmp: jax.Array,
         t_ref_to_cmp: jax.Array) -> EpiGeo:
    """Precompute cached quantities (reference epipolar_geometry.h:86-103)."""
    R = se3.quat_to_matrix(q_ref_to_cmp)
    # HIGHEST precision: a GPU may run f32 matmuls in TF32 (10-bit
    # mantissa), and a 2^-11 relative error on KRKinv entries (~525)
    # shifts infinite-depth projections by ~0.1-0.3 px — a systematic
    # disparity bias worth several percent of inverse depth at small
    # baselines. These are 3x3 mats; cost is nil.
    hi = jax.lax.Precision.HIGHEST
    KRKinv = jnp.matmul(K, jnp.matmul(R, Kinv, precision=hi), precision=hi)
    Kt = jnp.matmul(K, t_ref_to_cmp, precision=hi)
    t_cmp_to_ref = -se3.quat_rotate(se3.quat_conj(q_ref_to_cmp), t_ref_to_cmp)
    tz = t_ref_to_cmp[2]
    safe_tz = jnp.where(jnp.abs(tz) > 0, tz, 1.0)
    epipole = jnp.stack([
        (K[0, 0] * t_ref_to_cmp[0] + K[0, 2] * tz) / safe_tz,
        (K[1, 1] * t_ref_to_cmp[1] + K[1, 2] * tz) / safe_tz,
    ])
    return EpiGeo(K=K, Kinv=Kinv, q_ref_to_cmp=q_ref_to_cmp,
                  t_ref_to_cmp=t_ref_to_cmp, t_cmp_to_ref=t_cmp_to_ref,
                  KRKinv=KRKinv, Kt=Kt, epipole=epipole)


def load_relative(K: jax.Array, Kinv: jax.Array, T_ref, T_cmp) -> EpiGeo:
    """Build geometry from world poses of the two cameras."""
    q, t = se3.relative(T_cmp, T_ref)
    return load(K, Kinv, q, t)


def compose(geo2: EpiGeo, geos: EpiGeo) -> EpiGeo:
    """Geometry ref->cmp2 from (possibly batched) ref->cmp geometries and
    ONE cmp->cmp2 geometry geo2 — without re-running the per-feature
    K R Kinv chains (K Kinv cancels in the middle):
      KRKinv' = KRKinv_2 @ KRKinv,  Kt' = KRKinv_2 @ Kt + Kt_2.
    The tracking step uses this to derive per-feature anchor->poseframe
    geometries from the already-built anchor->new set (one broadcasted
    3x3 matmul instead of 4096 quat-to-matrix + double-matmul chains)."""
    hi = jax.lax.Precision.HIGHEST
    q = se3.quat_mul(geo2.q_ref_to_cmp, geos.q_ref_to_cmp)
    t = se3.quat_rotate(geo2.q_ref_to_cmp, geos.t_ref_to_cmp) \
        + geo2.t_ref_to_cmp
    KRKinv = jnp.matmul(geo2.KRKinv, geos.KRKinv, precision=hi)
    Kt = jnp.matmul(geos.Kt, geo2.KRKinv.T, precision=hi) + geo2.Kt
    t_cmp_to_ref = -se3.quat_rotate(se3.quat_conj(q), t)
    K = geos.K
    tz = t[..., 2]
    safe_tz = jnp.where(jnp.abs(tz) > 0, tz, 1.0)
    epipole = jnp.stack([
        (K[..., 0, 0] * t[..., 0] + K[..., 0, 2] * tz) / safe_tz,
        (K[..., 1, 1] * t[..., 1] + K[..., 1, 2] * tz) / safe_tz,
    ], axis=-1)
    return EpiGeo(K=geos.K, Kinv=geos.Kinv, q_ref_to_cmp=q,
                  t_ref_to_cmp=t, t_cmp_to_ref=t_cmp_to_ref,
                  KRKinv=KRKinv, Kt=Kt, epipole=epipole)


def _apply33(M: jax.Array, uv: jax.Array) -> jax.Array:
    """Homogeneous 3x3 action on pixel batch (..., 2) -> (..., 3)."""
    x = M[0, 0] * uv[..., 0] + M[0, 1] * uv[..., 1] + M[0, 2]
    y = M[1, 0] * uv[..., 0] + M[1, 1] * uv[..., 1] + M[1, 2]
    w = M[2, 0] * uv[..., 0] + M[2, 1] * uv[..., 1] + M[2, 2]
    return jnp.stack([x, y, w], axis=-1)


def max_depth_projection(geo: EpiGeo, u_ref: jax.Array) -> jax.Array:
    """Projection of u_ref at infinite depth (reference :191-201)."""
    h = _apply33(geo.KRKinv, u_ref)
    return h[..., :2] / h[..., 2:3]


def min_depth_projection(geo: EpiGeo, u_ref: jax.Array) -> jax.Array:
    """Projection of u_ref at minimum (zero) depth (reference :237-263).

    Three cases on sign of t_ref_to_cmp.z, evaluated branchlessly:
      tz > 0: the epipole.
      tz == 0: u_inf + 1e6 * (fx*tx, fy*ty) (parallel epilines).
      tz < 0: project the ref point whose depth maps to depth 1 in cmp.
    """
    tz = geo.t_ref_to_cmp[2]
    u_inf = max_depth_projection(geo, u_ref)

    # Case tz == 0.
    epi_par = jnp.stack([geo.K[0, 0] * geo.t_ref_to_cmp[0],
                         geo.K[1, 1] * geo.t_ref_to_cmp[1]])
    u_par = u_inf + 1e6 * epi_par

    # Case tz < 0: depth in ref frame such that cmp depth is 1.
    qp_x = geo.Kinv[0, 0] * u_ref[..., 0] + geo.Kinv[0, 2]
    qp_y = geo.Kinv[1, 1] * u_ref[..., 1] + geo.Kinv[1, 2]
    qp = jnp.stack([qp_x, qp_y, jnp.ones_like(qp_x)], axis=-1)
    qp = se3.quat_rotate(geo.q_ref_to_cmp, qp)
    safe_qpz = jnp.where(jnp.abs(qp[..., 2]) > 0, qp[..., 2], 1.0)
    min_depth = (1.0 - tz) / safe_qpz
    p_cmp = min_depth[..., None] * qp + geo.t_ref_to_cmp
    safe_pz = jnp.where(jnp.abs(p_cmp[..., 2]) > 0, p_cmp[..., 2], 1.0)
    u_neg = jnp.stack([
        (geo.K[0, 0] * p_cmp[..., 0] + geo.K[0, 2] * p_cmp[..., 2]) / safe_pz,
        (geo.K[1, 1] * p_cmp[..., 1] + geo.K[1, 2] * p_cmp[..., 2]) / safe_pz,
    ], axis=-1)

    u_min = jnp.where(tz > 0, jnp.broadcast_to(geo.epipole, u_inf.shape),
                      jnp.where(tz == 0, u_par, u_neg))
    return u_min


def project_idepth(geo: EpiGeo, u_ref: jax.Array, idepth: jax.Array):
    """Project u_ref into cmp frame given inverse depth; also return the new
    inverse depth in the cmp frame (reference :153-180).

    idepth == 0 maps to the infinite-depth projection with new_idepth = 0.
    Returns (u_cmp (..., 2), new_idepth (...)).
    """
    idepth = jnp.asarray(idepth)
    safe_id = jnp.where(idepth > 0, idepth, 1.0)
    depth = 1.0 / safe_id

    p_ref_x = geo.Kinv[0, 0] * u_ref[..., 0] + geo.Kinv[0, 2]
    p_ref_y = geo.Kinv[1, 1] * u_ref[..., 1] + geo.Kinv[1, 2]
    p_ref = jnp.stack([p_ref_x, p_ref_y, jnp.ones_like(p_ref_x)],
                      axis=-1) * depth[..., None]
    p_cmp = se3.quat_rotate(geo.q_ref_to_cmp, p_ref) + geo.t_ref_to_cmp
    safe_pz = jnp.where(jnp.abs(p_cmp[..., 2]) > 0, p_cmp[..., 2], 1.0)
    new_idepth = 1.0 / safe_pz
    u_cmp = jnp.stack([
        (geo.K[0, 0] * p_cmp[..., 0] + geo.K[0, 2] * p_cmp[..., 2]) * new_idepth,
        (geo.K[1, 1] * p_cmp[..., 1] + geo.K[1, 2] * p_cmp[..., 2]) * new_idepth,
    ], axis=-1)

    u_inf = max_depth_projection(geo, u_ref)
    zero = idepth <= 0
    u_out = jnp.where(zero[..., None], u_inf, u_cmp)
    id_out = jnp.where(zero, 0.0, new_idepth)
    return u_out, id_out


def epiline(geo: EpiGeo, u_ref: jax.Array):
    """Epiline in the cmp image: (u_inf start point, unit direction toward
    minimum depth). Zero direction if degenerate (reference :282-300)."""
    u_zero = min_depth_projection(geo, u_ref)
    u_inf = max_depth_projection(geo, u_ref)
    epi = u_zero - u_inf
    norm2 = jnp.sum(epi * epi, axis=-1, keepdims=True)
    unit = epi / jnp.sqrt(jnp.where(norm2 > 1e-10, norm2, 1.0))
    unit = jnp.where(norm2 > 1e-10, unit, jnp.zeros_like(unit))
    return u_inf, unit


def reference_epiline(geo: EpiGeo, u_ref: jax.Array) -> jax.Array:
    """Unit epiline direction in the *reference* image at u_ref, pointing from
    near depth to far depth (reference :311-331)."""
    ex = (-geo.K[0, 0] * geo.t_cmp_to_ref[0]
          + geo.t_cmp_to_ref[2] * (u_ref[..., 0] - geo.K[0, 2]))
    ey = (-geo.K[1, 1] * geo.t_cmp_to_ref[1]
          + geo.t_cmp_to_ref[2] * (u_ref[..., 1] - geo.K[1, 2]))
    e = jnp.stack([ex, ey], axis=-1)
    n2 = jnp.sum(e * e, axis=-1, keepdims=True)
    return e / jnp.sqrt(jnp.maximum(n2, 1e-24))


def disparity(geo: EpiGeo, u_ref: jax.Array, u_cmp: jax.Array):
    """Signed disparity of the correspondence along the epiline
    (reference :342-354). Returns (disp, u_inf, epi_unit)."""
    u_inf, epi = epiline(geo, u_ref)
    d = jnp.sum(epi * (u_cmp - u_inf), axis=-1)
    return d, u_inf, epi


def disparity_to_idepth(geo: EpiGeo, u_ref: jax.Array, u_inf: jax.Array,
                        epi: jax.Array, disp: jax.Array) -> jax.Array:
    """Inverse depth (in the reference frame) from disparity along the
    epiline, via 1D least squares (reference :392-407)."""
    w = (geo.KRKinv[2, 0] * u_ref[..., 0] + geo.KRKinv[2, 1] * u_ref[..., 1]
         + geo.KRKinv[2, 2])
    u_d = u_inf + disp[..., None] * epi
    A = jnp.stack([geo.Kt[0] - geo.Kt[2] * u_d[..., 0],
                   geo.Kt[1] - geo.Kt[2] * u_d[..., 1]], axis=-1)
    b = (w * disp)[..., None] * epi
    ATA = jnp.sum(A * A, axis=-1)
    ATb = jnp.sum(A * b, axis=-1)
    return ATb / jnp.maximum(ATA, 1e-24)


def disparity_to_depth(geo: EpiGeo, u_ref: jax.Array, u_inf: jax.Array,
                       epi: jax.Array, disp: jax.Array) -> jax.Array:
    """Depth from disparity (reference :365-379)."""
    w = (geo.KRKinv[2, 0] * u_ref[..., 0] + geo.KRKinv[2, 1] * u_ref[..., 1]
         + geo.KRKinv[2, 2])
    u_d = u_inf + disp[..., None] * epi
    A = (w * disp)[..., None] * epi
    b = jnp.stack([geo.Kt[0] - geo.Kt[2] * u_d[..., 0],
                   geo.Kt[1] - geo.Kt[2] * u_d[..., 1]], axis=-1)
    ATA = jnp.sum(A * A, axis=-1)
    ATb = jnp.sum(A * b, axis=-1)
    return ATb / jnp.maximum(ATA, 1e-24)
