"""Display-mesh triangle filters and vertex normals, batched over the mesh.

JAX re-design of the reference's per-triangle loops
(/root/reference/src/flame/flame.cc:2207-2361 filters, :2529-2663 normals):
each filter is one masked whole-mesh computation; the triangle-averaged
vertex normals use segment-sum instead of sequential accumulate (the
reference's running average re-normalizes after every triangle; we
normalize the sum once, which preserves direction semantics while being
order-independent).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from flame_tpu.params import TriangleFilterParams


class CornerGeometry(NamedTuple):
    """Shared per-triangle corner data: ONE row gather feeds the filters
    and the normals (instead of gathering verts/idepths separately in
    each filter)."""

    uv: jax.Array  # (T, 3, 2) corner pixel positions
    ids: jax.Array  # (T, 3) corner idepths
    p: jax.Array  # (T, 3, 3) camera-frame 3D corner positions


def corner_geometry(Kinv: jax.Array, verts: jax.Array, idepths: jax.Array,
                    tris: jax.Array) -> CornerGeometry:
    packed = jnp.concatenate(
        [verts, idepths[:, None], jnp.zeros_like(idepths[:, None])], axis=1)
    c = packed[tris]  # (T, 3, 4) — the one gather
    uv = c[..., :2]
    ids = c[..., 2]
    x = Kinv[0, 0] * uv[..., 0] + Kinv[0, 2]
    y = Kinv[1, 1] * uv[..., 1] + Kinv[1, 2]
    rays = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)  # (T, 3, 3)
    safe = jnp.where(ids > 0, ids, 1.0)[..., None]
    return CornerGeometry(uv=uv, ids=ids, p=rays / safe)


def _backproject_tri(Kinv: jax.Array, verts: jax.Array, idepths: jax.Array,
                     tris: jax.Array, geom: CornerGeometry = None):
    """Camera-frame 3D corner positions for each triangle: (T, 3, 3)."""
    if geom is None:
        geom = corner_geometry(Kinv, verts, idepths, tris)
    return geom.p, geom.ids


def oblique_filter(params: TriangleFilterParams, Kinv: jax.Array,
                   verts: jax.Array, idepths: jax.Array, tris: jax.Array,
                   validity: jax.Array,
                   geom: CornerGeometry = None) -> jax.Array:
    """Drop triangles viewed too obliquely or spanning too much idepth
    (reference flame.cc:2207-2283)."""
    p, ids = _backproject_tri(Kinv, verts, idepths, tris, geom)
    p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]

    normal = jnp.cross(p1 - p0, p2 - p0)
    nn = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)
    ray = (p0 + p1 + p2) / 3.0
    ray = ray / jnp.maximum(jnp.linalg.norm(ray, axis=-1, keepdims=True),
                            1e-12)
    cosang = jnp.clip(jnp.sum(ray * nn, axis=-1), -1.0, 1.0)
    angle = jnp.abs(jnp.arccos(cosang))
    bad = angle > params.oblique_normal_thresh

    min_id = jnp.min(ids, axis=-1)
    max_id = jnp.max(ids, axis=-1)
    safe_max = jnp.where(max_id != 0, max_id, 1.0)
    bad |= (max_id - min_id) / safe_max > params.oblique_idepth_diff_factor
    bad |= (max_id - min_id) > params.oblique_idepth_diff_abs
    return validity & ~bad


def edge_length_filter(params: TriangleFilterParams, width: int,
                       verts: jax.Array, tris: jax.Array,
                       validity: jax.Array,
                       geom: CornerGeometry = None) -> jax.Array:
    """Drop triangles with any edge longer than a fraction of image width
    (reference flame.cc:2285-2328)."""
    uv = geom.uv if geom is not None else verts[tris]  # (T, 3, 2)
    thresh2 = (params.edge_length_thresh * width) ** 2
    d01 = jnp.sum((uv[:, 0] - uv[:, 1]) ** 2, axis=-1)
    d02 = jnp.sum((uv[:, 0] - uv[:, 2]) ** 2, axis=-1)
    d12 = jnp.sum((uv[:, 1] - uv[:, 2]) ** 2, axis=-1)
    bad = (d01 > thresh2) | (d02 > thresh2) | (d12 > thresh2)
    return validity & ~bad


def idepth_filter(params: TriangleFilterParams, idepths: jax.Array,
                  tris: jax.Array, validity: jax.Array,
                  geom: CornerGeometry = None) -> jax.Array:
    """Drop far-away triangles (mean idepth below threshold, reference
    flame.cc:2330-2361)."""
    mean_id = jnp.mean(geom.ids if geom is not None else idepths[tris],
                       axis=-1)
    return validity & ~(mean_id < params.min_triangle_idepth)


def apply_filters(params: TriangleFilterParams, Kinv: jax.Array, width: int,
                  verts: jax.Array, idepths: jax.Array, tris: jax.Array,
                  tri_mask: jax.Array,
                  geom: CornerGeometry = None) -> jax.Array:
    """All enabled filters (reference flame.cc:389-407)."""
    if geom is None:
        geom = corner_geometry(Kinv, verts, idepths, tris)
    v = tri_mask
    if params.do_oblique_filter:
        v = oblique_filter(params, Kinv, verts, idepths, tris, v, geom)
    if params.do_edge_length_filter:
        v = edge_length_filter(params, width, verts, tris, v, geom)
    if params.do_idepth_filter:
        v = idepth_filter(params, idepths, tris, v, geom)
    return v


def vertex_normals(Kinv: jax.Array, verts: jax.Array, idepths: jax.Array,
                   tris: jax.Array, tri_mask: jax.Array,
                   geom: CornerGeometry = None) -> jax.Array:
    """Triangle-averaged outward vertex normals (reference
    flame.cc:2554-2640). Triangles with any non-positive corner idepth are
    skipped, like the reference. Returns (V, 3) unit normals (zero where a
    vertex touches no valid triangle)."""
    V = verts.shape[0]
    p, ids = _backproject_tri(Kinv, verts, idepths, tris, geom)
    p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]

    # Outward normal: cross(delta2, delta1) for the canonical winding
    # (reference flame.cc:2608-2612).
    normal = jnp.cross(p2 - p0, p1 - p0)
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)

    ok = tri_mask & jnp.all(ids > 0, axis=-1)
    normal = jnp.where(ok[:, None], normal, 0.0)

    acc = jnp.zeros((V, 3), normal.dtype)
    for k in range(3):
        acc = acc + jax.ops.segment_sum(normal, tris[:, k], num_segments=V)
    norms = jnp.linalg.norm(acc, axis=-1, keepdims=True)
    return jnp.where(norms > 1e-8, acc / jnp.maximum(norms, 1e-12), 0.0)


def plane_param_normal(K: jax.Array, uv: jax.Array, idepth: jax.Array,
                       w1: jax.Array, w2: jax.Array) -> jax.Array:
    """Analytic outward normal from the NLTGV2 plane parameters (w1, w2)
    (reference flame.cc:2643-2663). Batched over vertices."""
    fx, fy = K[0, 0], K[1, 1]
    a = w1 * uv[..., 0] + w2 * uv[..., 1] - w1 * fx - w2 * fy
    b = fx * fx * w1 * w1 + fy * fy * w2 * w2 + (idepth - a) ** 2
    d = 1.0 / jnp.sqrt(jnp.maximum(b, 1e-24))
    n = jnp.stack([fx * w1 * d, fy * w2 * d, (idepth - a) * d], axis=-1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return -n
