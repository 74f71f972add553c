"""Kernel unit tests vs closed forms: interpolation, gradients, pyramids,
clipping, rasterization (mirrors the reference's image_utils/rasterization
test strategy, /root/reference/test/utils/image_utils_test.cc and
rasterization_test.cc)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flame_tpu.ops import interp, gradients, pyramid, clipping, rasterize


# ---------------------------------------------------------------------------
# Bilinear interpolation.
# ---------------------------------------------------------------------------


def ref_bilinear(img, x, y):
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    dx, dy = x - x0, y - y0
    return ((1 - dx) * (1 - dy) * img[y0, x0] + dx * (1 - dy) * img[y0, x0 + 1]
            + (1 - dx) * dy * img[y0 + 1, x0] + dx * dy * img[y0 + 1, x0 + 1])


def test_bilinear_matches_scalar(rng):
    img = rng.uniform(0, 255, size=(32, 48)).astype(np.float32)
    xs = rng.uniform(0, 46.9, size=100).astype(np.float32)
    ys = rng.uniform(0, 30.9, size=100).astype(np.float32)
    got = np.asarray(interp.bilinear(jnp.asarray(img), jnp.asarray(xs),
                                     jnp.asarray(ys)))
    want = np.array([ref_bilinear(img, x, y) for x, y in zip(xs, ys)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_bilinear_integer_positions(rng):
    img = rng.uniform(0, 255, size=(16, 16)).astype(np.float32)
    got = np.asarray(interp.bilinear(jnp.asarray(img), jnp.asarray([3.0, 7.0]),
                                     jnp.asarray([2.0, 5.0])))
    np.testing.assert_allclose(got, [img[2, 3], img[5, 7]], rtol=1e-6)


def test_bilinear_stack_selects_frame(rng):
    imgs = rng.uniform(0, 255, size=(3, 16, 16)).astype(np.float32)
    x = jnp.asarray([4.5, 4.5, 4.5])
    y = jnp.asarray([8.25, 8.25, 8.25])
    fidx = jnp.asarray([0, 1, 2])
    got = np.asarray(interp.bilinear_stack(jnp.asarray(imgs), fidx, x, y))
    for f in range(3):
        want = np.asarray(interp.bilinear(jnp.asarray(imgs[f]), x[:1], y[:1]))[0]
        np.testing.assert_allclose(got[f], want, rtol=1e-6)


def test_bilinear_stack_packed_matches_unpacked(rng):
    """The persistent packed-corner table path (img_pack=) must agree
    exactly with plain bilinear_stack for integer-valued (u8-sourced)
    images — bf16 corner storage is exact for 0..255 and the weights
    stay f32."""
    imgs = rng.integers(0, 256, size=(3, 16, 20)).astype(np.float32)
    pack = jnp.concatenate(
        [interp.pack_image(jnp.asarray(f)) for f in imgs], axis=0)
    x = jnp.asarray(rng.uniform(0, 18.9, size=64).astype(np.float32))
    y = jnp.asarray(rng.uniform(0, 14.9, size=64).astype(np.float32))
    fidx = jnp.asarray(rng.integers(0, 3, size=64), jnp.int32)
    got = np.asarray(interp.bilinear_stack(jnp.asarray(imgs), fidx, x, y,
                                           img_pack=pack))
    want = np.asarray(interp.bilinear_stack(jnp.asarray(imgs), fidx, x, y))
    np.testing.assert_array_equal(got, want)
    # f32 tables (the table_bf16=False escape hatch) agree as well.
    pack32 = jnp.concatenate(
        [interp.pack_image(jnp.asarray(f), jnp.float32) for f in imgs],
        axis=0)
    got32 = np.asarray(interp.bilinear_stack(jnp.asarray(imgs), fidx, x, y,
                                             img_pack=pack32))
    np.testing.assert_array_equal(got32, want)


def test_bilinear_bf16_table_exact_for_u8(rng):
    """bilinear(pack_dtype=bf16) is bit-identical to f32 tables on
    integer-valued images (the LineStereoParams.table_bf16 guarantee)."""
    img = jnp.asarray(rng.integers(0, 256, size=(24, 24)).astype(np.float32))
    # Large query so both calls take the packed-table branch.
    x = jnp.asarray(rng.uniform(0, 22.9, size=(24 * 24,)).astype(np.float32))
    y = jnp.asarray(rng.uniform(0, 22.9, size=(24 * 24,)).astype(np.float32))
    a = np.asarray(interp.bilinear(img, x, y, pack_dtype=jnp.bfloat16))
    b = np.asarray(interp.bilinear(img, x, y))
    np.testing.assert_array_equal(a, b)


def test_stack_insert_maintains_img_pack(rng):
    """frame.insert / insert_masked keep the FrameStack img_pack invariant:
    rows [slot*T, (slot+1)*T) == pack_image(img_pad[slot]); a masked-off
    insert leaves the table untouched."""
    from flame_tpu.core import frame as frame_mod
    H, W, pad = 12, 16, 2
    stack = frame_mod.empty_stack(3, H, W, pad)
    img = rng.integers(0, 256, size=(H, W)).astype(np.float32)
    q = jnp.asarray([1.0, 0, 0, 0])
    t = jnp.zeros(3)
    fr = frame_mod.create(7, q, t, jnp.asarray(img), pad)
    T = (H + 2 * pad) * (W + 2 * pad)

    stack = frame_mod.insert(stack, 1, fr)
    want = np.asarray(interp.pack_image(fr.img_pad))
    np.testing.assert_array_equal(
        np.asarray(stack.img_pack[T:2 * T]), want)

    img2 = rng.integers(0, 256, size=(H, W)).astype(np.float32)
    fr2 = frame_mod.create(8, q, t, jnp.asarray(img2), pad)
    off = frame_mod.insert_masked(stack, 2, fr2, jnp.asarray(False))
    np.testing.assert_array_equal(np.asarray(off.img_pack),
                                  np.asarray(stack.img_pack))
    on = frame_mod.insert_masked(stack, 2, fr2, jnp.asarray(True))
    np.testing.assert_array_equal(
        np.asarray(on.img_pack[2 * T:]),
        np.asarray(interp.pack_image(fr2.img_pad)))


def test_nearest_rounds_half_up(rng):
    img = jnp.arange(25.0).reshape(5, 5)
    got = np.asarray(interp.nearest(img, jnp.asarray([1.5, 1.49]),
                                    jnp.asarray([2.5, 2.49])))
    assert got[0] == 3 * 5 + 2  # rounds to (2, 3)
    assert got[1] == 2 * 5 + 1  # rounds to (2, 1)


# ---------------------------------------------------------------------------
# Gradients (reference semantics: central interior, fwd/bwd borders).
# ---------------------------------------------------------------------------


def test_central_gradient_linear_ramp():
    H, W = 12, 20
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 3.0 * xx + 5.0 * yy
    gx, gy = gradients.central_gradient(jnp.asarray(img))
    np.testing.assert_allclose(np.asarray(gx), 3.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gy), 5.0, atol=1e-5)


def test_central_gradient_matches_naive(rng):
    img = rng.uniform(0, 255, size=(10, 14)).astype(np.float32)
    gx, gy = gradients.central_gradient(jnp.asarray(img))
    gx, gy = np.asarray(gx), np.asarray(gy)
    # Interior.
    want_gx = 0.5 * (img[:, 2:] - img[:, :-2])
    np.testing.assert_allclose(gx[:, 1:-1], want_gx, atol=1e-5)
    # Borders: forward/backward difference.
    np.testing.assert_allclose(gx[:, 0], img[:, 1] - img[:, 0], atol=1e-5)
    np.testing.assert_allclose(gx[:, -1], img[:, -1] - img[:, -2], atol=1e-5)
    np.testing.assert_allclose(gy[0, :], img[1, :] - img[0, :], atol=1e-5)
    np.testing.assert_allclose(gy[-1, :], img[-1, :] - img[-2, :], atol=1e-5)


def test_max_filter3(rng):
    img = rng.uniform(0, 10, size=(8, 9)).astype(np.float32)
    got = np.asarray(gradients.max_filter3(jnp.asarray(img)))
    pad = np.pad(img, 1, mode="edge")
    want = np.zeros_like(img)
    for i in range(8):
        for j in range(9):
            want[i, j] = pad[i:i + 3, j:j + 3].max()
    np.testing.assert_allclose(got, want)


# ---------------------------------------------------------------------------
# Pyramid.
# ---------------------------------------------------------------------------


def test_pyramid_shapes(rng):
    img = rng.uniform(0, 255, size=(64, 96)).astype(np.float32)
    levels = pyramid.gaussian_pyramid(jnp.asarray(img), 3)
    assert [lvl.shape for lvl in levels] == [(64, 96), (32, 48), (16, 24)]


def test_pyramid_constant_preserved():
    img = jnp.full((32, 32), 7.0)
    levels = pyramid.gaussian_pyramid(img, 3)
    for lvl in levels:
        np.testing.assert_allclose(np.asarray(lvl), 7.0, atol=1e-5)


def test_pyramid_montage_layout():
    """Montage layout of reference pyramids.cc:29-70: level 0 left,
    levels 1+ stacked top-down in the right column."""
    img = np.arange(64 * 96, dtype=np.float32).reshape(64, 96)
    levels = pyramid.gaussian_pyramid(jnp.asarray(img), 3)
    m = pyramid.montage(levels)
    assert m.shape == (64, 96 + 48)
    np.testing.assert_array_equal(m[:, :96], np.asarray(levels[0]))
    np.testing.assert_array_equal(m[:32, 96:144], np.asarray(levels[1]))
    np.testing.assert_array_equal(m[32:48, 96:120], np.asarray(levels[2]))
    assert (m[48:, 96:] == 0).all()


# ---------------------------------------------------------------------------
# Liang-Barsky clipping (reference image_utils.cc:269-371 semantics).
# ---------------------------------------------------------------------------


def test_clip_inside_unchanged():
    v, x0, y0, x1, y1 = clipping.clip_line(0, 10, 0, 10, 2, 3, 7, 8)
    assert bool(v)
    np.testing.assert_allclose([x0, y0, x1, y1], [2, 3, 7, 8], atol=1e-6)


def test_clip_crossing():
    v, x0, y0, x1, y1 = clipping.clip_line(0, 10, 0, 10, -5, 5, 15, 5)
    assert bool(v)
    np.testing.assert_allclose([x0, y0, x1, y1], [0, 5, 10, 5], atol=1e-5)


def test_clip_outside_rejected():
    v, *_ = clipping.clip_line(0, 10, 0, 10, -5, 20, 15, 20)
    assert not bool(v)
    # Diagonal missing the box.
    v, *_ = clipping.clip_line(0, 10, 0, 10, 11, 0, 20, 5)
    assert not bool(v)


def test_clip_diagonal():
    v, x0, y0, x1, y1 = clipping.clip_line(0, 10, 0, 10, -2, -2, 12, 12)
    assert bool(v)
    np.testing.assert_allclose([x0, y0, x1, y1], [0, 0, 10, 10], atol=1e-5)


def test_clip_batched(rng):
    x0 = rng.uniform(-20, 20, 64).astype(np.float32)
    y0 = rng.uniform(-20, 20, 64).astype(np.float32)
    x1 = rng.uniform(-20, 20, 64).astype(np.float32)
    y1 = rng.uniform(-20, 20, 64).astype(np.float32)
    v, cx0, cy0, cx1, cy1 = clipping.clip_line(0, 10, 0, 10, x0, y0, x1, y1)
    v = np.asarray(v)
    for arr in (cx0, cy0, cx1, cy1):
        arr = np.asarray(arr)
        assert np.all(arr >= -1e-5) and np.all(arr <= 10 + 1e-5)
    # Cross-check each scalar result.
    for i in range(64):
        vi, *_ = clipping.clip_line(0, 10, 0, 10, x0[i], y0[i], x1[i], y1[i])
        assert bool(vi) == bool(v[i])


# ---------------------------------------------------------------------------
# Rasterization.
# ---------------------------------------------------------------------------


def _simple_mesh():
    # Two triangles covering a quad [2, 12] x [2, 10], plus a far triangle.
    verts = jnp.array([[2.0, 2.0], [12.0, 2.0], [12.0, 10.0], [2.0, 10.0],
                       [20.0, 20.0], [25.0, 20.0], [20.0, 25.0]])
    tris = jnp.array([[0, 1, 2], [0, 2, 3], [4, 5, 6]], dtype=jnp.int32)
    vals = jnp.array([1.0, 2.0, 3.0, 4.0, 5.0, 5.0, 5.0])
    return verts, tris, vals


def test_rasterize_bruteforce_interpolates_plane():
    verts, tris, vals = _simple_mesh()
    valid = jnp.array([True, True, True])
    img = np.asarray(rasterize.rasterize_bruteforce(
        verts, tris, vals, valid, 32, 32))
    # Inside first triangle at its centroid.
    assert not np.isnan(img[4, 9])
    # v is affine over the quad: v(x, y) = 1 + (x-2)/10 + 2*(y-2)/8 ... the
    # two triangles interpolate their own planes; check vertices exactly.
    np.testing.assert_allclose(img[2, 2], 1.0, atol=1e-4)
    np.testing.assert_allclose(img[2, 12], 2.0, atol=1e-4)
    np.testing.assert_allclose(img[10, 12], 3.0, atol=1e-4)
    np.testing.assert_allclose(img[10, 2], 4.0, atol=1e-4)
    # Outside any triangle -> NaN.
    assert np.isnan(img[0, 0])
    assert np.isnan(img[31, 31])
    # Far triangle constant value.
    np.testing.assert_allclose(img[21, 21], 5.0, atol=1e-4)


def test_rasterize_validity_mask():
    verts, tris, vals = _simple_mesh()
    valid = jnp.array([True, True, False])
    img = np.asarray(rasterize.rasterize_bruteforce(
        verts, tris, vals, valid, 32, 32))
    assert np.isnan(img[21, 21])
    assert not np.isnan(img[4, 9])


def test_rasterize_binned_matches_bruteforce(rng):
    """Golden-equivalence: the tiled production rasterizer must reproduce the
    brute-force result on a random Delaunay-like mesh."""
    from scipy.spatial import Delaunay as SDelaunay
    pts = rng.uniform(5, 120, size=(60, 2)).astype(np.float32)
    dt = SDelaunay(pts)
    verts = jnp.asarray(pts)
    tris = jnp.asarray(dt.simplices.astype(np.int32))
    vals = jnp.asarray(rng.uniform(0.5, 2.0, size=60).astype(np.float32))
    valid = jnp.ones(tris.shape[0], dtype=bool)

    brute = np.asarray(rasterize.rasterize_bruteforce(
        verts, tris, vals, valid, 128, 128))
    binned = np.asarray(rasterize.rasterize(
        verts, tris, vals, valid, 128, 128, tile_h=16, tile_w=32,
        max_per_tile=64))
    np.testing.assert_allclose(binned, brute, atol=1e-4, equal_nan=True)


def test_rasterize_binned_production_params(rng):
    """The production tile/cell geometry (64x128 tiles, 16x32 cells) must
    stay exact on a random mesh denser than the detection grid produces."""
    from scipy.spatial import Delaunay as SDelaunay
    H, W = 192, 256
    pts = rng.uniform([4, 4], [W - 4, H - 4], size=(350, 2)).astype(
        np.float32)
    dt = SDelaunay(pts)
    verts = jnp.asarray(pts)
    tris = jnp.asarray(dt.simplices.astype(np.int32))
    vals = jnp.asarray(rng.uniform(0.5, 2.0, size=350).astype(np.float32))
    valid = jnp.ones(tris.shape[0], dtype=bool)

    brute = np.asarray(rasterize.rasterize_bruteforce(
        verts, tris, vals, valid, H, W))
    binned = np.asarray(rasterize.rasterize(verts, tris, vals, valid, H, W))
    np.testing.assert_allclose(binned, brute, atol=1e-4, equal_nan=True)


def test_rasterize_winding_invariance():
    verts, tris, vals = _simple_mesh()
    valid = jnp.ones(3, dtype=bool)
    img1 = np.asarray(rasterize.rasterize_bruteforce(
        verts, tris, vals, valid, 32, 32))
    tris_rev = tris[:, ::-1]
    img2 = np.asarray(rasterize.rasterize_bruteforce(
        verts, tris_rev, vals, valid, 32, 32))
    np.testing.assert_allclose(img1, img2, atol=1e-5, equal_nan=True)


def test_interpolate_mesh_vertex_validity():
    verts, tris, vals = _simple_mesh()
    tri_valid = jnp.ones(3, dtype=bool)
    vtx_valid = jnp.array([True, True, True, True, False, True, True])
    img = np.asarray(rasterize.interpolate_mesh(
        verts, tris, vals, tri_valid, vtx_valid, 32, 32))
    assert np.isnan(img[21, 21])  # triangle with invalid vertex dropped
    assert not np.isnan(img[4, 9])


def _random_delaunay(rng, n, hi, T=512):
    from scipy.spatial import Delaunay as SDelaunay
    pts = rng.uniform([4, 4], hi, (n, 2)).astype(np.float32)
    sd = SDelaunay(pts)
    tris = np.zeros((T, 3), np.int32)
    tris[:sd.simplices.shape[0]] = sd.simplices
    tm = np.zeros(T, bool)
    tm[:sd.simplices.shape[0]] = True
    return pts, tris, tm


def test_rasterize_auto_matches_bruteforce(rng):
    """The production rasterizer (rasterize, tile-binned) must reproduce
    the brute-force rasterizer exactly on a random Delaunay mesh, without
    overflowing a bin."""
    H, W = 120, 160
    pts, tris, tm = _random_delaunay(rng, 180, [156, 116])
    vals = rng.uniform(0.5, 2.0, 180).astype(np.float32)

    ref = np.asarray(rasterize.rasterize_bruteforce(
        jnp.asarray(pts), jnp.asarray(tris), jnp.asarray(vals),
        jnp.asarray(tm), H, W))
    out = np.asarray(rasterize.rasterize(
        jnp.asarray(pts), jnp.asarray(tris), jnp.asarray(vals),
        jnp.asarray(tm), H, W))
    _, overflow = rasterize.rasterize_binned(
        jnp.asarray(pts), jnp.asarray(tris), jnp.asarray(vals),
        jnp.asarray(tm), H, W)
    assert int(overflow) == 0
    assert (np.isnan(ref) == np.isnan(out)).all()
    m = ~np.isnan(ref)
    np.testing.assert_allclose(out[m], ref[m], atol=1e-5)


@pytest.mark.parametrize("B", [1, 4])
def test_rasterize_batch_auto_matches_per_view(rng, B):
    """rasterize_batch must reproduce per-view rasterize_bruteforce
    exactly: shifted viewpoints of one triangle set, per-view values and
    validity. 150 vertices in 136x96 px (one per ~87 px²) is about the
    bench's feature density, which overflowed the earlier per-cell
    capacity of 40."""
    H, W = 120, 160
    pts, tris, tm = _random_delaunay(rng, 150, [140, 100])
    # Per-view positions: translated + slightly scaled (projection-style
    # motion); per-view values and validity differ too.
    verts_b = np.stack([pts * (1.0 + 0.01 * b) + np.array([3.0 * b, -2.0 * b])
                        for b in range(B)]).astype(np.float32)
    vals_b = rng.uniform(0.5, 2.0, (B, 150)).astype(np.float32)
    tm_b = np.repeat(tm[None], B, axis=0)
    tm_b[B - 1, :10] = False  # view-specific invalidation

    out, overflow = rasterize.rasterize_batch(
        jnp.asarray(verts_b), jnp.asarray(tris), jnp.asarray(vals_b),
        jnp.asarray(tm_b), H, W)
    out = np.asarray(out)
    assert out.shape == (B, H, W)
    assert int(overflow) == 0
    for b in range(B):
        ref = np.asarray(rasterize.rasterize_bruteforce(
            jnp.asarray(verts_b[b]), jnp.asarray(tris),
            jnp.asarray(vals_b[b]), jnp.asarray(tm_b[b]), H, W))
        assert (np.isnan(ref) == np.isnan(out[b])).all(), b
        m = ~np.isnan(ref)
        np.testing.assert_allclose(out[b][m], ref[m], atol=1e-5)


def _overflowing_mesh(rng):
    """A random Delaunay mesh plus long slivers across the image, so that
    small bins overflow."""
    H, W = 96, 128
    pts, tris, tm = _random_delaunay(rng, 120, [124, 92], T=384)
    n = int(tm.sum())
    # Slivers: fans from the left edge to far-right vertices.
    left = np.argsort(pts[:, 0])[:6]
    right = np.argsort(pts[:, 0])[-40:]
    sl = np.stack([np.repeat(left, 20)[:40], right,
                   np.roll(right, 1)], axis=1).astype(np.int32)
    tris[n:n + 40] = sl
    tm[n:n + 40] = True
    vals = rng.uniform(0.5, 2.0, 120).astype(np.float32)
    return H, W, pts, tris, tm, vals


@pytest.mark.parametrize("batched", [False, True])
def test_rasterize_overflow_falls_back_exactly(rng, batched):
    """A bin that overflows is counted, and the map still equals the
    brute-force rasterizer's (the fallback), not the truncated binning."""
    H, W, pts, tris, tm, vals = _overflowing_mesh(rng)
    ref = np.asarray(rasterize.rasterize_bruteforce(
        jnp.asarray(pts), jnp.asarray(tris), jnp.asarray(vals),
        jnp.asarray(tm), H, W))
    small = dict(max_per_tile=16, max_per_cell=8)
    binned, n_lost = rasterize.rasterize_binned(
        jnp.asarray(pts), jnp.asarray(tris), jnp.asarray(vals),
        jnp.asarray(tm), H, W, **small)
    assert int(n_lost) > 0
    # The truncated binning alone is wrong somewhere: the fallback matters.
    assert not (np.isnan(np.asarray(binned)) == np.isnan(ref)).all()
    if batched:
        out, overflow = rasterize.rasterize_batch(
            jnp.asarray(pts)[None], jnp.asarray(tris),
            jnp.asarray(vals)[None], jnp.asarray(tm)[None], H, W, **small)
        out = np.asarray(out)[0]
        assert int(overflow) == int(n_lost)
    else:
        out = np.asarray(rasterize.rasterize(
            jnp.asarray(pts), jnp.asarray(tris), jnp.asarray(vals),
            jnp.asarray(tm), H, W, **small))
    assert (np.isnan(out) == np.isnan(ref)).all()
    m = ~np.isnan(ref)
    np.testing.assert_allclose(out[m], ref[m], atol=1e-5)


def test_rasterize_overflow_count_is_bbox_excess(rng):
    """The overflow count is the summed excess of bbox overlaps over each
    bin's capacity: with one tile and one cell covering a small image,
    it is (triangles touching it) - capacity at both levels."""
    H, W = 16, 32
    pts, tris, tm = _random_delaunay(rng, 30, [28, 12], T=64)
    n = int(tm.sum())
    vals = np.ones(30, np.float32)
    _, overflow = rasterize.rasterize_binned(
        jnp.asarray(pts), jnp.asarray(tris), jnp.asarray(vals),
        jnp.asarray(tm), H, W, truncate=False, tile_h=16, tile_w=32,
        cell_h=16, cell_w=32, max_per_tile=n - 5, max_per_cell=n - 9)
    # Level 1 drops 5 of n; level 2 then holds n - 5 candidates in a
    # capacity of n - 9 and drops 4 more.
    assert int(overflow) == 5 + 4
