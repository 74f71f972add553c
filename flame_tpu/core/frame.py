"""Per-image frames and the fixed-capacity poseframe stack.

JAX re-design of the reference's Frame
(/root/reference/src/flame/utils/frame.h:38-68, frame.cc:33-71): a frame is
a pytree of device arrays (image, reflect-101-padded image, central
gradients, cached dense idepthmap) plus its SE(3) pose. Poseframes
(keyframes) live in a stacked [F, ...] array with a validity mask so every
per-feature computation can gather its anchor frame's image/pose with one
index — the array-world replacement for the reference's
map<id, Frame::Ptr> (flame.h:FrameIDToFrame).

The reference builds multi-level pyramids but runs the pipeline at level 0
only (flame.cc:150 creates frames with num_levels=1); we store level 0 and
expose flame_tpu.ops.pyramid for callers that want pyramids.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from flame_tpu.ops.gradients import central_gradient
from flame_tpu.ops import interp


class Frame(NamedTuple):
    frame_id: jax.Array  # () int32 external id
    q: jax.Array  # (4,) pose: camera-to-world rotation
    t: jax.Array  # (3,) camera-to-world translation
    img: jax.Array  # (H, W) float32
    img_pad: jax.Array  # (H + 2p, W + 2p) reflect-101 padded
    gradx: jax.Array  # (H, W)
    grady: jax.Array  # (H, W)


@functools.partial(jax.jit, static_argnames=("pad",))
def create(frame_id, q, t, img, pad: int) -> Frame:
    """Build a frame: float image, reflect-101 padding, central gradients
    (reference frame.cc:33-71; pad == filter win_size, flame.cc:149)."""
    f = img.astype(jnp.float32)
    img_pad = jnp.pad(f, pad, mode="reflect")  # reflect-101 == np 'reflect'
    gx, gy = central_gradient(f)
    return Frame(frame_id=jnp.asarray(frame_id, jnp.int32),
                 q=q.astype(jnp.float32), t=t.astype(jnp.float32),
                 img=f, img_pad=img_pad, gradx=gx, grady=gy)


@functools.partial(jax.jit, static_argnames=("height", "width", "pad"))
def create_from_buf(frame_id, q, t, buf, height: int, width: int,
                    pad: int) -> Frame:
    """create() from the leading height*width uint8 bytes of a coalesced
    upload buffer (see core/flame.py: the image and the frame's topology
    ride one upload; the split happens on device inside this jit)."""
    img = buf[: height * width].reshape(height, width)
    return create.__wrapped__(frame_id, q, t, img, pad)


class FrameStack(NamedTuple):
    """Fixed-capacity poseframe table [F]."""

    frame_id: jax.Array  # (F,) int32, -1 when free
    q: jax.Array  # (F, 4)
    t: jax.Array  # (F, 3)
    img_pad: jax.Array  # (F, H+2p, W+2p)
    # Persistent packed-corner table of img_pad, (F*(H+2p)*(W+2p), 4)
    # bf16 — maintained at insert time so the track loop's ref-patch
    # sampling is one row gather instead of a 4-corner element gather
    # (see interp.bilinear_stack's img_pack path). bf16 is exact for
    # u8-sourced images. Kept FLAT (frame-major rows) rather than
    # (F, T, 4): a reshape between the scan carry and the gather made XLA
    # insert per-iteration layout-conversion loops. INVARIANT: rows
    # [i*T, (i+1)*T) == pack_image(img_pad[i]) whenever valid[i].
    img_pack: jax.Array
    gradx: jax.Array  # (F, H, W)
    grady: jax.Array  # (F, H, W)
    idepthmap: jax.Array  # (F, H, W) cached dense idepth (NaN = none)
    valid: jax.Array  # (F,) bool


def empty_stack(capacity: int, height: int, width: int, pad: int,
                pack_dtype=jnp.float32) -> FrameStack:
    """pack_dtype: storage dtype of the img_pack sample table. The
    default float32 is exact for any imagery; bf16 is exact for
    u8-sourced imagery only (8 mantissa bits cover 0..255) and ~40%
    faster to gather — Flame opts in via LineStereoParams.table_bf16,
    which governs the whole pipeline. Direct callers with float-valued
    imagery must NOT pass bf16 (silent ~2^-8 relative quantization vs
    the f32 img_pad the non-packed paths read). insert/insert_masked
    derive the dtype from the existing table."""
    F = capacity
    return FrameStack(
        frame_id=jnp.full((F,), -1, jnp.int32),
        q=jnp.tile(jnp.array([1.0, 0, 0, 0], jnp.float32), (F, 1)),
        t=jnp.zeros((F, 3), jnp.float32),
        img_pad=jnp.zeros((F, height + 2 * pad, width + 2 * pad), jnp.float32),
        img_pack=jnp.zeros(
            (F * (height + 2 * pad) * (width + 2 * pad), 4), pack_dtype),
        gradx=jnp.zeros((F, height, width), jnp.float32),
        grady=jnp.zeros((F, height, width), jnp.float32),
        idepthmap=jnp.full((F, height, width), jnp.nan, jnp.float32),
        valid=jnp.zeros((F,), bool))


@jax.jit
def insert(stack: FrameStack, slot, frame: Frame) -> FrameStack:
    """Write a frame into a poseframe slot.

    NOT donated: donating the ~100 MB stack makes the dispatch wait until
    every in-flight computation referencing the old stack retires, which
    blocks the host once the pipeline runs deep; the full-stack device
    copy does not.

    slot is clamped to [0, F): the per-field .at[].set scatters (OOB
    drops, negative wraps) and the img_pack dynamic_update_slice (start
    clamps) would otherwise desync on an out-of-range slot, silently
    breaking the img_pack == pack_image(img_pad) invariant."""
    slot = jnp.clip(jnp.asarray(slot, jnp.int32), 0,
                    stack.valid.shape[0] - 1)
    H, W = stack.gradx.shape[1:]
    return stack._replace(
        frame_id=stack.frame_id.at[slot].set(frame.frame_id),
        q=stack.q.at[slot].set(frame.q),
        t=stack.t.at[slot].set(frame.t),
        img_pad=stack.img_pad.at[slot].set(frame.img_pad),
        img_pack=jax.lax.dynamic_update_slice_in_dim(
            stack.img_pack,
            interp.pack_image(frame.img_pad, stack.img_pack.dtype),
            slot * frame.img_pad.size, 0),
        gradx=stack.gradx.at[slot].set(frame.gradx),
        grady=stack.grady.at[slot].set(frame.grady),
        idepthmap=stack.idepthmap.at[slot].set(jnp.full((H, W), jnp.nan)),
        valid=stack.valid.at[slot].set(True))


@jax.jit
def set_idepthmap(stack: FrameStack, slot, idepthmap) -> FrameStack:
    # Not donated — same dispatch stall as insert().
    return stack._replace(idepthmap=stack.idepthmap.at[slot].set(idepthmap))


def _masked_row_update(arr, slot, new_row, on):
    """Write new_row into arr[slot] when `on`, else write back the old
    row — an UNCONDITIONAL one-row dynamic-update-slice. Inside a
    lax.scan body this replaces lax.cond(on, insert, identity): XLA
    cannot alias a cond's carry operands across branches, so the cond
    form copied the full 20 MB poseframe stack every scan iteration; the
    masked DUS updates the carry buffer in place, and the no-op branch
    costs one row of read+write."""
    old = jax.lax.dynamic_slice_in_dim(arr, slot, 1, 0)
    row = jnp.where(on, new_row[None].astype(arr.dtype), old)
    return jax.lax.dynamic_update_slice_in_dim(arr, row, slot, 0)


@jax.jit
def insert_masked(stack: FrameStack, slot, frame: Frame, on) -> FrameStack:
    """insert() that becomes a no-op when `on` is False (traced bool) —
    the scan-body form of the poseframe insert (see _masked_row_update).
    slot is clamped for the same field-desync reason as insert()."""
    slot = jnp.clip(jnp.asarray(slot, jnp.int32), 0,
                    stack.valid.shape[0] - 1)
    H, W = stack.gradx.shape[1:]
    return stack._replace(
        frame_id=stack.frame_id.at[slot].set(
            jnp.where(on, frame.frame_id, stack.frame_id[slot])),
        q=stack.q.at[slot].set(jnp.where(on, frame.q, stack.q[slot])),
        t=stack.t.at[slot].set(jnp.where(on, frame.t, stack.t[slot])),
        img_pad=_masked_row_update(stack.img_pad, slot, frame.img_pad, on),
        # The pack build goes inside a cond so non-insert scan
        # iterations skip the compute, not just the write: unlike the
        # stack-carry cond that _masked_row_update replaced, the branch
        # output here is one frame's row block, so no carry-copy
        # pathology.
        img_pack=jax.lax.dynamic_update_slice_in_dim(
            stack.img_pack,
            jax.lax.cond(
                on,
                lambda: interp.pack_image(frame.img_pad,
                                          stack.img_pack.dtype),
                lambda: jax.lax.dynamic_slice_in_dim(
                    stack.img_pack, slot * frame.img_pad.size,
                    frame.img_pad.size, 0)),
            slot * frame.img_pad.size, 0),
        gradx=_masked_row_update(stack.gradx, slot, frame.gradx, on),
        grady=_masked_row_update(stack.grady, slot, frame.grady, on),
        idepthmap=_masked_row_update(
            stack.idepthmap, slot, jnp.full((H, W), jnp.nan), on),
        valid=stack.valid.at[slot].set(
            jnp.where(on, True, stack.valid[slot])))


@jax.jit
def set_idepthmap_masked(stack: FrameStack, slot, idepthmap,
                         on) -> FrameStack:
    """set_idepthmap() that no-ops when `on` is False (see
    _masked_row_update for why this form inside scan bodies)."""
    slot = jnp.asarray(slot, jnp.int32)
    return stack._replace(
        idepthmap=_masked_row_update(stack.idepthmap, slot, idepthmap, on))


@jax.jit
def set_poses(stack: FrameStack, slots, qs, ts) -> FrameStack:
    """Batch pose write-back (BA window application): ONE dispatch for
    all refined poses instead of one set_pose per frame."""
    return stack._replace(q=stack.q.at[slots].set(qs),
                          t=stack.t.at[slots].set(ts))


@jax.jit
def set_pose(stack: FrameStack, slot, q, t) -> FrameStack:
    """Update one poseframe pose (the updatePoseFramePoses hook,
    reference flame.h:155-164)."""
    return stack._replace(q=stack.q.at[slot].set(q),
                          t=stack.t.at[slot].set(t))


@jax.jit
def remove(stack: FrameStack, slot) -> FrameStack:
    return stack._replace(valid=stack.valid.at[slot].set(False),
                          frame_id=stack.frame_id.at[slot].set(-1))
