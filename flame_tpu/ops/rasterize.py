"""Barycentric mesh rasterization into dense value maps.

JAX replacement for the reference's SSE scanline rasterizer
(/root/reference/src/flame/utils/rasterization.cc:164-245) and
interpolateMesh (/root/reference/src/flame/utils/image_utils.cc:373-419).

Instead of per-triangle scanline loops with masked SSE stores, we evaluate
edge functions for (pixel, triangle) pairs and combine with a max-reduce:
a triangulation covers each pixel with at most one triangle, so reducing
`where(inside, value, -inf)` over triangles reconstructs the interpolated
map (ties on shared edges pick the max; the reference picks the
last-drawn triangle — values agree on edges up to interpolation error).

Two implementations:
  * rasterize_bruteforce: every triangle against every pixel, chunked scan.
    Reference implementation for tests.
  * rasterize: two-level tile binning. Triangles are binned to image tiles
    by bounding box, each tile only tests its K nearest-binned triangles.
    ~10x less work; everything stays dense and jit-friendly. When a bin
    overflows, the call falls back to rasterize_bruteforce, so the map is
    exact either way; rasterize_batch also returns the overflow count.

Semantics matched to the reference:
  * Vertex coordinates are truncated to integers before rasterization (the
    reference converts Point2f -> cv::Point, truncating toward zero,
    image_utils.cc:383-391).
  * A pixel is inside if all three edge functions are >= 0 for a CCW
    triangle; we normalize orientation by the signed area so either
    winding works (the reference manually reverses its CW triangles).
  * Background is NaN (flame.cc:412).
"""

import functools

import jax
import jax.numpy as jnp


def _tri_setup(verts: jax.Array, tris: jax.Array, truncate: bool,
               corners: jax.Array = None):
    """Per-triangle edge-function coefficients.

    verts: (V, 2) float vertex positions; tris: (T, 3) int32 indices.
    corners: optional pre-gathered (T, 3, 2) corner positions (NOT yet
    truncated). Returns a, b, c arrays of shape (T, 3) such that edge
    function k at pixel (x, y) is a[:, k]*x + b[:, k]*y + c[:, k],
    normalized to be >= 0 inside regardless of winding, plus area2 (T,)
    the normalization.
    """
    p = corners if corners is not None else verts[tris]  # (T, 3, 2)
    if truncate:
        p = jnp.trunc(p)
    v0, v1, v2 = p[:, 0], p[:, 1], p[:, 2]

    def edge_coeffs(pa, pb):
        # w(p) = cross(pb - pa, p - pa) = a*x + b*y + c.
        a = pa[:, 1] - pb[:, 1]
        b = pb[:, 0] - pa[:, 0]
        c = pb[:, 1] * pa[:, 0] - pb[:, 0] * pa[:, 1]
        return a, b, c

    # Barycentric numerators: w0 from edge (v1,v2), w1 from (v2,v0),
    # w2 from (v0,v1); w0+w1+w2 = 2*signed_area.
    a0, b0, c0 = edge_coeffs(v1, v2)
    a1, b1, c1 = edge_coeffs(v2, v0)
    a2, b2, c2 = edge_coeffs(v0, v1)

    a = jnp.stack([a0, a1, a2], axis=-1)
    b = jnp.stack([b0, b1, b2], axis=-1)
    c = jnp.stack([c0, c1, c2], axis=-1)

    area2 = (v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1]) - \
            (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0])

    # Normalize sign so inside => all w >= 0.
    sign = jnp.where(area2 < 0, -1.0, 1.0)[:, None]
    return a * sign, b * sign, c * sign, jnp.abs(area2)


def _eval_chunk(a, b, c, area2, vals, valid, xs, ys):
    """Evaluate a chunk of triangles over a pixel grid.

    a,b,c: (C, 3); area2, valid: (C,); vals: (C, 3);
    xs: (W,), ys: (H,). Returns (C, H, W) candidate values (-inf outside).
    """
    # w[k] = a*x + b*y + c  -> (C, 3, H, W) if naive; fold the x/y terms.
    x = xs[None, None, None, :]
    y = ys[None, None, :, None]
    w = (a[:, :, None, None] * x + b[:, :, None, None] * y
         + c[:, :, None, None])  # (C, 3, H, W)
    inside = jnp.all(w >= 0, axis=1) & (valid & (area2 > 0))[:, None, None]
    denom = jnp.where(area2 > 0, area2, 1.0)[:, None, None]
    # Elementwise contraction over the 3 corners (NOT einsum: a reduced-
    # precision matmul would bias the dense map — this stays f32 and
    # fuses into the surrounding elementwise graph).
    interp = (w[:, 0] * vals[:, 0, None, None]
              + w[:, 1] * vals[:, 1, None, None]
              + w[:, 2] * vals[:, 2, None, None]) / denom
    return jnp.where(inside, interp, -jnp.inf)


def rasterize_bruteforce(verts: jax.Array, tris: jax.Array, vals: jax.Array,
                         tri_valid: jax.Array, height: int, width: int,
                         truncate: bool = True, chunk: int = 128) -> jax.Array:
    """Reference-quality rasterizer: scan over triangle chunks.

    verts: (V, 2); tris: (T, 3) int32; vals: (V,); tri_valid: (T,) bool.
    Returns (H, W) float32 with NaN where uncovered.
    """
    T = tris.shape[0]
    pad = (-T) % chunk
    tris_p = jnp.pad(tris, ((0, pad), (0, 0)))
    valid_p = jnp.pad(tri_valid, (0, pad))

    a, b, c, area2 = _tri_setup(verts, tris_p, truncate)
    tvals = vals[tris_p]  # (T', 3)

    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)

    n_chunks = tris_p.shape[0] // chunk

    def body(carry, idx):
        sl = lambda arr: jax.lax.dynamic_slice_in_dim(arr, idx * chunk, chunk)
        cand = _eval_chunk(sl(a), sl(b), sl(c), sl(area2), sl(tvals),
                           sl(valid_p), xs, ys)
        return jnp.maximum(carry, jnp.max(cand, axis=0)), None

    init = jnp.full((height, width), -jnp.inf, dtype=jnp.float32)
    out, _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return jnp.where(jnp.isinf(out), jnp.nan, out)


# Bin capacities of the production rasterizer: triangles per 32x128 tile
# and per 16x32 cell. They must exceed the largest number of triangle
# bounding boxes that touch one tile / cell. Most triangles are small
# (median bbox ~14 px at 4096 features over VGA), but the mesh also carries
# long slivers (bboxes 100-600 px wide) whose bboxes pile up: in the bench
# scene's first 36 frames the busiest tile touches ~260 and the busiest
# cell ~125; later, stale triangles over recycled feature slots push the
# counts far higher (ROADMAP 3.8). A larger count is not lost — the call
# falls back to the brute-force rasterizer — but it costs that fallback's
# time, and the overflow is counted (rasterize_batch's second output,
# Flame.failure_stats()['raster_bin_overflow']).
MAX_PER_TILE = 512
MAX_PER_CELL = 256
# Triangles per chunk of the fallback's brute-force scan: bounds its
# (chunk, 3, H, W) edge-function temporary (~120 MB at VGA).
FALLBACK_CHUNK = 32


@functools.partial(jax.jit, static_argnames=(
    "height", "width", "truncate", "tile_h", "tile_w", "max_per_tile",
    "cell_h", "cell_w", "max_per_cell"))
def rasterize_binned(verts: jax.Array, tris: jax.Array, vals: jax.Array,
                     tri_valid: jax.Array, height: int, width: int,
                     truncate: bool = True, tile_h: int = 32,
                     tile_w: int = 128, max_per_tile: int = MAX_PER_TILE,
                     cell_h: int = 16, cell_w: int = 32,
                     max_per_cell: int = MAX_PER_CELL):
    """Two-level tile-binned rasterizer, without the fallback. Returns
    (map, overflow): overflow counts the (bin, triangle) bbox overlaps
    that did not fit their bin's capacity; the map is exact when it is 0.

    Level 1 bins triangles to (tile_h x tile_w) image tiles by bbox
    overlap (mask over the full triangle array). Level 2 re-bins each
    tile's K1 candidates to (cell_h x cell_w) cells, so per-pixel work
    drops from K1 to K2 edge-function tests. Level-2 binning is cheap
    because its mask is (cells_per_tile, K1) not (n_cells, T).
    """
    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    n_tiles = nty * ntx
    cell_h = min(cell_h, tile_h)
    cell_w = min(cell_w, tile_w)
    assert tile_h % cell_h == 0 and tile_w % cell_w == 0, \
        (tile_h, tile_w, cell_h, cell_w)
    ncy = tile_h // cell_h  # cells per tile, vertically
    ncx = tile_w // cell_w
    n_cell = ncy * ncx

    T = tris.shape[0]
    # ONE corner gather feeds edge-function setup, values, and bboxes.
    vxy = jnp.concatenate([verts, vals[:, None],
                           jnp.zeros((verts.shape[0], 1), verts.dtype)],
                          axis=1)
    cg = vxy[tris]  # (T, 3, 4)
    a, b, c, area2 = _tri_setup(verts, tris, truncate, corners=cg[..., :2])
    tvals = cg[..., 2]

    # Pack per-triangle data into one matrix so the per-cell gather is a
    # single row gather.
    packed = jnp.concatenate(
        [a, b, c, tvals, area2[:, None],
         jnp.zeros((T, 3), a.dtype)], axis=1)  # (T, 16)

    # Triangle bboxes (in truncated-vertex space to match _tri_setup).
    p = cg[..., :2]
    if truncate:
        p = jnp.trunc(p)
    xmin = jnp.min(p[:, :, 0], axis=1)
    xmax = jnp.max(p[:, :, 0], axis=1)
    ymin = jnp.min(p[:, :, 1], axis=1)
    ymax = jnp.max(p[:, :, 1], axis=1)

    # Tile extents.
    tids = jnp.arange(n_tiles)
    ty = (tids // ntx).astype(jnp.float32) * tile_h
    tx = (tids % ntx).astype(jnp.float32) * tile_w

    # Level-1 overlap mask (n_tiles, T).
    overlap = ((xmin[None, :] <= tx[:, None] + (tile_w - 1)) &
               (xmax[None, :] >= tx[:, None]) &
               (ymin[None, :] <= ty[:, None] + (tile_h - 1)) &
               (ymax[None, :] >= ty[:, None]) &
               tri_valid[None, :] & (area2[None, :] > 0))

    # Per-tile compacted triangle indices via top_k on the masked iota
    # (a full argsort would sort ~1M keys).
    K = min(max_per_tile, T)
    overflow = jnp.sum(jnp.maximum(jnp.sum(overlap, axis=1) - K, 0))
    key = jnp.where(overlap, jnp.arange(T, dtype=jnp.int32)[None, :], -1)
    kvals, _ = jax.lax.top_k(key, K)  # (n_tiles, K), -1 padded
    order = jnp.maximum(kvals, 0)
    k_valid = kvals >= 0  # (n_tiles, K)

    # Level 2: bin each tile's K1 candidates to its cells. Bboxes of the
    # level-1 candidates, gathered per tile: (n_tiles, K).
    bxmin = xmin[order]
    bxmax = xmax[order]
    bymin = ymin[order]
    bymax = ymax[order]

    # Cell extents relative to each tile: (n_cell,).
    cids = jnp.arange(n_cell)
    cy = (cids // ncx).astype(jnp.float32) * cell_h  # offset within tile
    cx = (cids % ncx).astype(jnp.float32) * cell_w
    # Absolute cell extents: (n_tiles, n_cell).
    acy = ty[:, None] + cy[None, :]
    acx = tx[:, None] + cx[None, :]

    # (n_tiles, n_cell, K) overlap of candidate bboxes with cells.
    overlap2 = ((bxmin[:, None, :] <= acx[:, :, None] + (cell_w - 1)) &
                (bxmax[:, None, :] >= acx[:, :, None]) &
                (bymin[:, None, :] <= acy[:, :, None] + (cell_h - 1)) &
                (bymax[:, None, :] >= acy[:, :, None]) &
                k_valid[:, None, :])

    # Compact again with top_k over the k1 slots; map back to global ids.
    K2 = min(max_per_cell, K)
    overflow += jnp.sum(jnp.maximum(jnp.sum(overlap2, axis=2) - K2, 0))
    key2 = jnp.where(overlap2, jnp.arange(K, dtype=jnp.int32)[None, None, :],
                     -1)
    k2vals, _ = jax.lax.top_k(key2, K2)  # (n_tiles, n_cell, K2)
    c_valid = k2vals >= 0
    slot2 = jnp.maximum(k2vals, 0)
    order2 = jnp.take_along_axis(
        jnp.broadcast_to(order[:, None, :], (n_tiles, n_cell, K)),
        slot2, axis=2)

    # One row gather for all per-cell triangle data.
    cdata = packed[order2]  # (n_tiles, n_cell, K2, 16)
    ca = cdata[..., 0:3]
    cb = cdata[..., 3:6]
    cc = cdata[..., 6:9]
    cv = cdata[..., 9:12]
    carea = cdata[..., 12]

    ys_local = jnp.arange(cell_h, dtype=jnp.float32)
    xs_local = jnp.arange(cell_w, dtype=jnp.float32)

    def cell_fn(ca, cb, cc, carea, cv, kv, oy, ox):
        xs = xs_local + ox
        ys = ys_local + oy
        cand = _eval_chunk(ca, cb, cc, carea, cv, kv, xs, ys)
        return jnp.max(cand, axis=0)  # (cell_h, cell_w)

    f = jax.vmap(jax.vmap(cell_fn))
    cells = f(ca, cb, cc, carea, cv, c_valid,
              jnp.broadcast_to(acy, (n_tiles, n_cell)),
              jnp.broadcast_to(acx, (n_tiles, n_cell)))

    # Reassemble (nty, ntx, ncy, ncx, ch, cw) -> (H', W') -> crop.
    img = cells.reshape(nty, ntx, ncy, ncx, cell_h, cell_w)
    img = img.transpose(0, 2, 4, 1, 3, 5)
    img = img.reshape(nty * tile_h, ntx * tile_w)[:height, :width]
    return jnp.where(jnp.isinf(img), jnp.nan, img), overflow


def _bruteforce(verts, tris, vals, tri_valid, height, width, truncate):
    return rasterize_bruteforce(verts, tris, vals, tri_valid, height, width,
                                truncate=truncate, chunk=FALLBACK_CHUNK)


def rasterize(verts: jax.Array, tris: jax.Array, vals: jax.Array,
              tri_valid: jax.Array, height: int, width: int,
              truncate: bool = True, **bins) -> jax.Array:
    """The production rasterizer: rasterize_binned, or rasterize_bruteforce
    when a bin overflowed. verts (V, 2), tris (T, 3), vals (V,), tri_valid
    (T,) -> (H, W) with NaN background. bins: rasterize_binned's tile/cell
    geometry and capacities."""
    img, overflow = rasterize_binned(verts, tris, vals, tri_valid, height,
                                     width, truncate=truncate, **bins)
    return jax.lax.cond(
        overflow > 0,
        lambda: _bruteforce(verts, tris, vals, tri_valid, height, width,
                            truncate),
        lambda: img)


def rasterize_batch(verts: jax.Array, tris: jax.Array, vals: jax.Array,
                    tri_valid: jax.Array, height: int, width: int, **bins):
    """Rasterize one triangle set from B viewpoints: verts (B, V, 2),
    vals (B, V), tri_valid (B, T) -> ((B, H, W) maps, overflow summed over
    the views). The binned pass is a vmap over the views (each view bins
    its own triangles); if any view overflowed, the whole batch is redrawn
    by the brute-force rasterizer, one view at a time."""
    imgs, overflow = jax.vmap(
        lambda v, x, tv: rasterize_binned(v, tris, x, tv, height, width,
                                          **bins))(verts, vals, tri_valid)
    overflow = jnp.sum(overflow)
    imgs = jax.lax.cond(
        overflow > 0,
        lambda: jax.lax.map(
            lambda a: _bruteforce(a[0], tris, a[1], a[2], height, width,
                                  True), (verts, vals, tri_valid)),
        lambda: imgs)
    return imgs, overflow


def interpolate_mesh(verts: jax.Array, tris: jax.Array, vals: jax.Array,
                     tri_valid: jax.Array, vtx_valid: jax.Array,
                     height: int, width: int, **kwargs) -> jax.Array:
    """interpolateMesh equivalent (reference image_utils.cc:373-396):
    a triangle is drawn iff the triangle and all three vertices are valid."""
    ok = tri_valid & jnp.all(vtx_valid[tris], axis=1)
    return rasterize(verts, tris, vals, ok, height, width, **kwargs)
