"""Accelerator-vs-CPU parity of the device stages.

Each check runs one stage of the pipeline twice — on the device under test
and on a reference device (the CPU backend) — from the same inputs, and
compares the results within a tolerance whose reason is stated beside it.
All f32 matrix products in these stages ask for Precision.HIGHEST
(tests/test_precision.py), so the differences left are summation order
and fused multiply-add contraction, not TF32 rounding.

chip_smoke.py runs these at the real widths; tests/test_gpu_parity.py
runs them at a small size on a GPU.
"""

import functools

import numpy as np
import jax

from flame_tpu.core import frame as frame_mod
from flame_tpu.core import pipeline
from flame_tpu.ops import rasterize
from flame_tpu.optimize import nltgv2

# Smoother: the primal x, w1, w2 within SMOOTHER_ATOL. The iteration is
# non-expansive (prox steps and unit-ball projections), so reduction-order
# differences of ~1e-7 per iteration do not grow over a frame's
# iterations. The duals q1..q3 (unit ball) within SMOOTHER_DUAL_ATOL: each
# dual ascent multiplies a primal difference by step_q * alpha (125 / the
# edge length in px, up to ~60 on the shortest edges), so a few-1e-7
# primal difference reaches the duals at ~1e-5; on an H100 against the
# CPU the largest dual difference read 1.03e-5 at VGA x 4096.
SMOOTHER_ATOL = 1e-5
SMOOTHER_DUAL_ATOL = 3e-5
# Rasterizer: a pixel on a shared triangle edge can flip between covered
# and uncovered when the edge function is contracted into an FMA on one
# backend and not the other, so the NaN masks need only agree on this
# share of pixels; values agree within RASTER_ATOL where both are defined.
# The binned pass must not overflow, or the comparison would be of the
# brute-force fallback with itself.
RASTER_MASK_AGREE = 0.999
RASTER_ATOL = 1e-5
# Tracking: near-ties in the SSD argmin of the epipolar search (and at the
# ambiguity and chi-square gates) can flip between backends and change
# whether a slot survives, so validity need only agree on this share of
# slots; idepth agrees within TRACK_RTOL where both backends keep the slot.
TRACK_VALID_AGREE = 0.99
TRACK_RTOL = 1e-4


def _put(tree, dev):
    return jax.device_put(tree, dev)


@functools.partial(jax.jit, static_argnames=("rparams", "n_iters"))
def _smooth(rparams, graph, n_iters):
    return nltgv2.smooth(rparams, graph, n_iters, mode="vertex")


def smoother(rparams, graph, n_iters: int, dev, ref_dev) -> dict:
    """The XLA vertex smoother (the production smoother), n_iters
    iterations from `graph` on both devices."""
    a = _smooth(rparams, _put(graph, dev), n_iters)
    b = _smooth(rparams, _put(graph, ref_dev), n_iters)
    vm = np.asarray(graph.vtx_mask)
    em = np.asarray(graph.edge_mask)
    diff = {}
    for name, m in (("x", vm), ("w1", vm), ("w2", vm),
                    ("q1", em), ("q2", em), ("q3", em)):
        d = np.abs(np.asarray(getattr(a, name)) - np.asarray(getattr(b, name)))
        diff[name] = float(d[m].max()) if m.any() else 0.0
    ok = (all(diff[k] <= SMOOTHER_ATOL for k in ("x", "w1", "w2"))
          and all(diff[k] <= SMOOTHER_DUAL_ATOL for k in ("q1", "q2", "q3")))
    return {"max_abs_diff": diff, "atol_primal": SMOOTHER_ATOL,
            "atol_duals": SMOOTHER_DUAL_ATOL, "ok": ok}


@functools.partial(jax.jit, static_argnames=("height", "width"))
def _raster_batch(verts_b, tris, vals_b, tri_valid_b, height, width):
    return rasterize.rasterize_batch(verts_b, tris, vals_b, tri_valid_b,
                                     height, width)


@functools.partial(jax.jit, static_argnames=("height", "width"))
def _raster_ref(verts, tris, vals, tri_valid, height, width):
    return rasterize.rasterize_bruteforce(verts, tris, vals, tri_valid,
                                          height, width, chunk=32)


def raster(verts_b, tris, vals_b, tri_valid_b, height: int, width: int,
           dev, ref_dev) -> dict:
    """rasterize_batch over B views on `dev` against the brute-force
    rasterizer, view by view, on `ref_dev`."""
    out, overflow = _raster_batch(*_put((verts_b, tris, vals_b, tri_valid_b),
                                        dev), height, width)
    out, overflow = np.asarray(out), int(overflow)
    mask_agree, max_diff = 1.0, 0.0
    for b in range(out.shape[0]):
        ref = np.asarray(_raster_ref(*_put((verts_b[b], tris, vals_b[b],
                                            tri_valid_b[b]), ref_dev),
                                     height, width))
        na, nb = np.isnan(out[b]), np.isnan(ref)
        mask_agree = min(mask_agree, float(np.mean(na == nb)))
        both = ~na & ~nb
        if both.any():
            max_diff = max(max_diff,
                           float(np.abs(out[b][both] - ref[both]).max()))
    return {"views": int(out.shape[0]), "bin_overflow": overflow,
            "mask_agree_min": mask_agree, "max_abs_diff": max_diff,
            "mask_agree_bound": RASTER_MASK_AGREE, "atol": RASTER_ATOL,
            "ok": (overflow == 0 and mask_agree >= RASTER_MASK_AGREE
                   and max_diff <= RASTER_ATOL)}


def tracking(params, K, Kinv, stack, feats, frame_args, curr_pf_slot,
             dev, ref_dev) -> dict:
    """Frame creation from a uint8 image + track_project_sync over every
    feature slot. frame_args: (frame_id, q, t, img_u8)."""
    def run(d):
        fid, q, t, img = _put(frame_args, d)
        fnew = frame_mod.create(fid, q, t, img, params.pad)
        feats2, curr, _member, _stats, obs = pipeline.track_project_sync(
            params, *_put((K, Kinv, stack, feats), d), fnew,
            curr_pf_slot)
        return (np.asarray(curr.valid), np.asarray(obs.success),
                np.asarray(feats2.idepth_mu))

    va, sa, ia = run(dev)
    vb, sb, ib = run(ref_dev)
    agree = float(np.mean(va == vb))
    both = va & vb
    rel = (np.abs(ia[both] - ib[both])
           / np.maximum(np.abs(ib[both]), 1e-12))
    worst = float(rel.max()) if rel.size else 0.0
    return {"slots": int(va.shape[0]), "valid_dev": int(va.sum()),
            "valid_ref": int(vb.sum()), "valid_agree": agree,
            "success_dev": int(sa.sum()),
            "success_agree": float(np.mean(sa == sb)),
            "compared": int(both.sum()), "max_rel_idepth_diff": worst,
            "valid_agree_bound": TRACK_VALID_AGREE, "rtol": TRACK_RTOL,
            "ok": agree >= TRACK_VALID_AGREE and worst <= TRACK_RTOL}
