"""Batched epipolar line stereo matching.

JAX re-design of the reference's per-feature sliding-window SSD
matcher (/root/reference/src/flame/stereo/line_stereo.h:75-385, itself
derived from LSD-SLAM). The reference walks the epiline with a rolling
5-sample buffer in a data-dependent while loop; here the walk becomes a
dense [N_features, N_steps] computation:

  * All candidate samples S[m] = img(start + m*step) for m in [-2, NSTEPS+1]
    are gathered at once (one XLA gather per image).
  * Per-step SSD ee[k] and the one-sided SSD slopes between consecutive
    steps (which the reference forms from a cross-correlation accumulated
    in alternating A/B buffers) are small reductions over the 5-tap axis.
  * Best/second-best selection, the non-adjacent ambiguity test, and the
    subpixel zero-crossing refinement are masked arithmetic reproducing the
    reference's exact decision tree.

Steps beyond the (per-feature, data-dependent) end of the search segment
are masked with +inf cost, which reproduces the reference's loop-exit
condition without dynamic control flow.
"""

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from flame_tpu.ops import interp
from flame_tpu.params import LineStereoParams

# Status codes (reference line_stereo.h:38-42).
SUCCESS = 0
FAIL_AMBIGUOUS_MATCH = 1
FAIL_MAX_COST = 2

# A step this fraction of sample_dist past the segment's end still runs
# (see the activity mask in match).
END_SLACK = 1e-3


class MatchResult(NamedTuple):
    status: jax.Array  # (N,) int32
    u_cmp: jax.Array  # (N, 2) matched pixel (in img_cmp coordinates)
    residual: jax.Array  # (N,) final (possibly subpixel-refined) SSD
    best_idx: jax.Array  # (N,) int32 integer step of the best match


def n_steps_for(epilength_max: float, sample_dist: float = 1.0) -> int:
    """Static step-count bound for a given max epiline length at the
    configured sample spacing (ignoring sample_dist would silently
    truncate the searched segment when sample_dist < 1: the far end of a
    long epiline would never be sampled, returning a confident wrong
    minimum instead of the true match)."""
    return int(math.ceil(epilength_max / sample_dist)) + 2


def match(ref_patch: jax.Array, img_cmp: jax.Array, start: jax.Array,
          end: jax.Array, rescale_factor: jax.Array,
          params: LineStereoParams, n_steps: int) -> MatchResult:
    """Match 5-tap reference patches along epipolar segments.

    ref_patch: (N, 5) patch values ordered [-2e, -e, 0, +e, +2e] along the
        reference epiline (reference inverse_depth_filter.cc:211-225).
    img_cmp: (H, W) comparison image (padded; coordinates pre-offset).
    start, end: (N, 2) search segment endpoints in img_cmp coordinates.
    rescale_factor: (N,) patch warp factor.
    n_steps: static number of unit steps (use n_steps_for(epilength_max)).
    """
    N = ref_patch.shape[0]
    f32max = jnp.float32(jnp.finfo(jnp.float32).max)

    diff = end - start
    length = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    safe_len = jnp.maximum(length, 1e-12)
    inc = diff * (params.sample_dist / safe_len)[:, None]  # (N, 2)

    # Step activity mask replicating the loop-entry condition
    # (line_stereo.h:168-169): continue while cp has not passed end in
    # either coordinate; step 0 always runs. Away from the end that is
    # k * sample_dist <= length. The reference compares positions, which
    # turns on rounding whenever a step lands on `end` — as it does for
    # every segment padded to epilength_min, an integer number of steps
    # long — or a direction component is ~0 (then every step's test is
    # rounding), so two backends with different rounding disagreed on the
    # steps searched and with them on the match. The step count is
    # compared instead, with END_SLACK of a step so that a step on `end`
    # runs in either direction, which keeps a padded segment's steps
    # symmetric about its centre.
    ks = jnp.arange(n_steps, dtype=jnp.float32)
    pos = start[:, None, :] + ks[None, :, None] * inc[:, None, :]  # (N, S, 2)
    active = (ks[None, :] * params.sample_dist
              <= length[:, None] + END_SLACK * params.sample_dist)
    active = active.at[:, 0].set(True)

    # Gather all samples: positions m in [-2, n_steps+1] along the line.
    ms = jnp.arange(-2, n_steps + 2, dtype=jnp.float32)  # (M,)
    spos = start[:, None, :] + ms[None, :, None] * inc[:, None, :]  # (N, M, 2)
    S = interp.bilinear(
        img_cmp, spos[..., 0], spos[..., 1],
        pack_dtype=jnp.bfloat16 if params.table_bf16 else None)  # (N, M)

    # Residuals per step/tap: E[k, j] = S[k + j] - ref[j] using the sample
    # window S[k-2 .. k+2] (offset by +2 in S indexing).
    # Build (N, S, 5) windows via slicing.
    windows = jnp.stack([S[:, j:j + n_steps] for j in range(5)], axis=-1)
    E = windows - ref_patch[:, None, :]  # (N, S, 5)
    ee = jnp.sum(E * E, axis=-1)  # (N, S)

    # The subpixel step needs the one-sided slopes of the SSD between
    # consecutive steps. With CC[k] = sum_j E[k, j] * E[k-1, j] (the
    # cross-correlation the reference accumulates in alternating A/B
    # buffers) they are ee[k] - CC[k] and CC[k] - ee[k-1]: differences of
    # two nearly equal sums whose sign a change of rounding flips. The same
    # slopes are formed here without the cancellation, from
    # D[k, j] = E[k, j] - E[k-1, j] = S[k+j] - S[k+j-1]:
    #   slope_in[k]  = sum_j E[k, j] * D[k, j]    (= ee[k] - CC[k])
    #   slope_out[k] = sum_j E[k-1, j] * D[k, j]  (= CC[k] - ee[k-1])
    # defined for k >= 1 (step 0 has no predecessor; it is padded with 0
    # and never read, since its pre-step error is the -1 sentinel).
    dS = S[:, 1:] - S[:, :-1]
    D = jnp.stack([dS[:, j:j + n_steps - 1] for j in range(5)], axis=-1)
    zero = jnp.zeros((N, 1), jnp.float32)
    slope_in = jnp.concatenate(
        [zero, jnp.sum(E[:, 1:, :] * D, axis=-1)], axis=1)  # (N, S)
    slope_out = jnp.concatenate(
        [zero, jnp.sum(E[:, :-1, :] * D, axis=-1)], axis=1)  # (N, S)

    ee_masked = jnp.where(active, ee, f32max)
    best = jnp.argmin(ee_masked, axis=1)  # (N,)
    best_err = jnp.take_along_axis(ee_masked, best[:, None], axis=1)[:, 0]

    # Second best: min over steps not equal to best. (The reference's running
    # second-best tracker reduces to exactly this; see SURVEY notes.)
    second_masked = jnp.where(
        jnp.arange(n_steps)[None, :] == best[:, None], f32max, ee_masked)
    second_idx = jnp.argmin(second_masked, axis=1)
    second_err = jnp.take_along_axis(second_masked, second_idx[:, None],
                                     axis=1)[:, 0]

    # Pre/post errors and cross terms at the winner. Sentinel -1 when the
    # neighbor step did not run (reference initializes errPre from
    # eeLast = -1 at step 0 and errPost = -1 when best is the final step).
    idx = jnp.arange(n_steps)[None, :]
    has_pre = best >= 1
    post_step = jnp.clip(best + 1, 0, n_steps - 1)
    has_post = jnp.take_along_axis(active, post_step[:, None], axis=1)[:, 0] \
        & (best + 1 <= n_steps - 1)

    take = lambda arr, i: jnp.take_along_axis(arr, i[:, None], axis=1)[:, 0]
    err_pre = jnp.where(has_pre, take(ee, jnp.maximum(best - 1, 0)), -1.0)
    err_post = jnp.where(has_post, take(ee, post_step), -1.0)

    # ---- Threshold test #1 (pre-subpixel): line_stereo.h:260-270.
    fail_max_cost_1 = best_err > 4.0 * params.max_cost

    # ---- Ambiguity test: line_stereo.h:273-283.
    non_adjacent = jnp.abs(best - second_idx) > 1
    fail_ambiguous = non_adjacent & (
        params.second_best_factor * best_err > second_err)

    # ---- Subpixel refinement: line_stereo.h:286-343, whose four gradients
    # are these slopes (see slope_in / slope_out above).
    grad_pre_pre = take(slope_out, best)
    grad_pre_this = take(slope_in, best)
    grad_post_this = take(slope_out, post_step)
    grad_post_post = take(slope_in, post_step)

    oob = (err_pre < 0) | (err_post < 0)
    inconsistent = (grad_post_this < 0) != (grad_pre_this < 0)
    pre_crossing = (grad_pre_pre < 0) != (grad_pre_this < 0)
    post_crossing = (grad_post_post < 0) != (grad_post_this < 0)

    interp_pre = (~oob) & (~inconsistent) & pre_crossing & (~post_crossing)
    interp_post = (~oob) & (~inconsistent) & (~pre_crossing) & post_crossing

    d_pre = grad_pre_this / jnp.where(
        jnp.abs(grad_pre_this - grad_pre_pre) > 0,
        grad_pre_this - grad_pre_pre, 1.0)
    d_post = grad_post_this / jnp.where(
        jnp.abs(grad_post_this - grad_post_post) > 0,
        grad_post_this - grad_post_post, 1.0)

    err_sub_pre = best_err - 2 * d_pre * grad_pre_this - \
        (grad_pre_pre - grad_pre_this) * d_pre * d_pre
    err_sub_post = best_err + 2 * d_post * grad_post_this + \
        (grad_post_post - grad_post_this) * d_post * d_post

    best_pos = jnp.take_along_axis(
        pos, best[:, None, None].repeat(2, -1), axis=1)[:, 0, :]  # (N, 2)

    if params.do_subpixel:
        shift = jnp.where(interp_pre[:, None], -d_pre[:, None] * inc,
                          jnp.where(interp_post[:, None],
                                    d_post[:, None] * inc,
                                    jnp.zeros_like(inc)))
        final_pos = best_pos + shift
        final_err = jnp.where(interp_pre, err_sub_pre,
                              jnp.where(interp_post, err_sub_post, best_err))
    else:
        final_pos = best_pos
        final_err = best_err

    # ---- Threshold test #2 (post-subpixel, gradient-slack):
    # line_stereo.h:347-372.
    sample_dist = params.sample_dist * rescale_factor
    dref = ref_patch[:, 1:] - ref_patch[:, :-1]
    grad_along_line = jnp.sum(dref * dref, axis=-1) / \
        jnp.maximum(sample_dist * sample_dist, 1e-24)
    fail_max_cost_2 = final_err > params.max_cost + \
        jnp.sqrt(grad_along_line) * 20.0

    status = jnp.where(
        fail_max_cost_1, FAIL_MAX_COST,
        jnp.where(fail_ambiguous, FAIL_AMBIGUOUS_MATCH,
                  jnp.where(fail_max_cost_2, FAIL_MAX_COST, SUCCESS)))

    return MatchResult(status=status.astype(jnp.int32), u_cmp=final_pos,
                       residual=final_err, best_idx=best.astype(jnp.int32))
