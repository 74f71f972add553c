"""Bilinear interpolation via vectorized gathers.

Replaces the reference's scalar bilinearInterp template and its SSE4.1
specialization (/root/reference/src/flame/utils/image_utils.h:231-319) with
a batched gather formulation: arbitrary batches of (x, y) sample positions
gather their 4 corner pixels in one XLA gather, so the epipolar-search hot
path (line_stereo) fuses into a handful of device ops.

Convention matches the reference: the value at integer coordinate (x0, y0)
is img[y0, x0]; samples must satisfy 0 <= x < W-1 and 0 <= y < H-1 for a
fully-interior gather (callers clamp, as the reference asserts).
"""

import jax
import jax.numpy as jnp


def _pack4(flat: jax.Array, W: int) -> jax.Array:
    """(H*W,) -> (H*W, 4) rows [v(i), v(i+1), v(i+W), v(i+W+1)].

    Packing the 2x2 corner neighborhood into one row turns bilinear
    sampling into a single ROW gather with 1/4 the indices (gathers pay
    per index more than per byte). The jnp.roll wraparound rows are never
    gathered (positions are clamped to the interior).
    """
    return jnp.stack([flat,
                      jnp.roll(flat, -1),
                      jnp.roll(flat, -W),
                      jnp.roll(flat, -W - 1)], axis=1)


def _weights4(dx, dy):
    return jnp.concatenate([(1 - dx) * (1 - dy), dx * (1 - dy),
                            (1 - dx) * dy, dx * dy], axis=-1)


def bilinear(img: jax.Array, x: jax.Array, y: jax.Array,
             pack_dtype=None) -> jax.Array:
    """Sample img (H, W) at float positions (x, y) of any batch shape.

    Out-of-range positions are clamped to the valid interior (the reference
    instead asserts; clamping keeps the op total for masked lanes).

    pack_dtype: optional storage dtype for the packed-corner table (large
    queries only). jnp.bfloat16 halves the gathered row bytes and is EXACT
    for integer-valued images (bf16's 8 mantissa bits represent 0..255
    exactly; the reference's images are u8, image_utils.h:231-272), so the
    interpolated values are bit-identical for u8 sources. Non-integer
    float images quantize at ~2^-8 relative.
    """
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]

    flat = img.reshape(-1).astype(jnp.float32)
    idx00 = y0.astype(jnp.int32) * W + x0.astype(jnp.int32)
    if x.size * 8 >= img.size:
        # Packed-corner rows: one gather with 1/4 the indices. The
        # (H*W, 4) table build is O(image), so it only pays when the
        # sample count is within ~an order of the pixel count (the
        # line-stereo [N, S] sampling).
        if pack_dtype is not None:
            flat = flat.astype(pack_dtype)
        v = _pack4(flat, W)[idx00].astype(jnp.float32)
    else:
        # Small query (e.g. one sample per feature, 4096 of 307k
        # pixels): gather the 4 corners directly — the table path would
        # pay a full-image table build and layout transpose to serve a
        # few thousand samples. Under vmap x.size is the per-lane size,
        # so vmapped per-feature calls take this path.
        idx = jnp.stack([idx00, idx00 + 1, idx00 + W, idx00 + W + 1],
                        axis=-1)
        v = flat[idx]
    return jnp.sum(v * _weights4(dx, dy), axis=-1)


def bilinear_uv(img: jax.Array, uv: jax.Array) -> jax.Array:
    """bilinear() with stacked (..., 2) positions in (x, y) order."""
    return bilinear(img, uv[..., 0], uv[..., 1])


def bilinear_stack(imgs: jax.Array, frame_idx: jax.Array, x: jax.Array,
                   y: jax.Array, packed: bool = None,
                   img_pack: jax.Array = None) -> jax.Array:
    """Sample from a stack of images (F, H, W), selecting image frame_idx per
    sample. Used when each feature samples its own anchor poseframe's image
    (reference flame.cc:1691: pfs.at(feat.frame_id)->img_pad).

    img_pack: optional PERSISTENT packed-corner table of the stack
    (frame.FrameStack.img_pack, flat (F*H*W, 4) rows maintained at
    poseframe-insert time). When given, sampling is one row gather
    against it — no per-call table build, no element gather. imgs still
    provides the
    (F, H, W) dims and the f32 fallback.

    packed: used only when img_pack is None. None picks by the
    samples-vs-pixels heuristic below; pass True/False to force.
    Callers whose stack is STATIC across many samples in one dispatch
    force True — the per-call table build amortizes — while in-scan
    callers over a MUTATING stack must never pack (the table would
    rebuild every scan iteration).
    """
    F, H, W = imgs.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]

    fidx = jnp.clip(frame_idx, 0, F - 1).astype(jnp.int32)
    idx00 = fidx * (H * W) + y0.astype(jnp.int32) * W + x0.astype(jnp.int32)
    if img_pack is not None:
        v = img_pack[idx00].astype(jnp.float32)
        return jnp.sum(v * _weights4(dx, dy), axis=-1)
    flat = imgs.reshape(-1).astype(jnp.float32)
    # Same size gate as bilinear(): the packed-corner table is O(stack),
    # so it only pays when the sample count is within ~an order of the
    # pixel count. Inside batch_step's scan the poseframe stack MUTATES
    # mid-batch, so a pack there rebuilds the 80 MB table (and runs
    # full-stack layout-conversion loops) EVERY scan iteration to serve
    # ~20k ref-patch samples. The direct 4-corner gather is O(samples)
    # regardless of stack mutation.
    if packed if packed is not None else (x.size * 8 >= imgs.size):
        # Packed-corner row gather as in bilinear(); the roll wraparound
        # between adjacent frames is never gathered (interior clamp keeps
        # idx00 + W + 1 within the sample's own frame).
        v = _pack4(flat, W)[idx00]
    else:
        idx = jnp.stack([idx00, idx00 + 1, idx00 + W, idx00 + W + 1],
                        axis=-1)
        v = flat[idx]
    return jnp.sum(v * _weights4(dx, dy), axis=-1)


def pack_image(img: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """(H, W) -> (H*W, 4) packed-corner rows for bilinear_stack(img_pack=).

    The rows are kept FLAT frame-major in FrameStack.img_pack — reshaping
    a (F, T, 4) scan carry for the gather made XLA insert per-iteration
    layout-conversion loops.

    bf16 storage is exact for integer-valued (u8-sourced) images — see
    bilinear(); it also halves the gathered bytes and the table footprint
    (LineStereoParams.table_bf16 selects the dtype for the pipeline's
    tables). Built once per frame at poseframe-insert time (frame.insert*),
    NOT per sample query: an in-scan full-image table rebuild per frame is
    why bilinear_stack gates on query size — the persistent per-slot table
    removes the rebuild entirely.
    """
    return _pack4(img.reshape(-1).astype(jnp.float32), img.shape[1]) \
        .astype(dtype)


def nearest(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Nearest-neighbor lookup with round-half-up, clamped to bounds
    (reference fast_roundf at flame.cc:749-752)."""
    H, W = img.shape
    xi = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, H - 1)
    return img.reshape(-1)[yi * W + xi]
