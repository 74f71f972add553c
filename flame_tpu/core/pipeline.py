"""Device-side per-frame pipeline steps (jitted, fixed shapes).

The reference's per-feature OpenMP loops and mutable-graph surgery
(/root/reference/src/flame/flame.cc: updateFeatureIDepths :1280-1534,
trackFeature :1536-1752, projectFeatures :1754-1860, projectGraph
:1862-1938, syncGraph :1940-2188) become whole-array jitted functions over
fixed-capacity SoA state. Feature slot i is graph vertex slot i — the
reference maintains a feat<->vertex bijection (feat_to_vtx_/vtx_to_feat_)
that this representation makes structural.

Every function here is shape-stable across frames so each jits exactly
once per configuration.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from flame_tpu.geometry import se3, epipolar
from flame_tpu.params import Params
from flame_tpu.stereo import filter as idfilter
from flame_tpu.stereo import line_stereo, meas_model
from flame_tpu.optimize import nltgv2
from flame_tpu.core.frame import Frame, FrameStack

# Failure-type counter indices (reference flame.cc:1301-1305, 1498-1504).
STAT_UPDATES = 0
STAT_FAIL_MAX_VAR = 1
STAT_FAIL_MAX_DROPOUTS = 2
STAT_FAIL_REF_PATCH = 3
STAT_FAIL_AMBIGUOUS = 4
STAT_FAIL_MAX_COST = 5
# Bin overflows of the batched dense rasterization (ops/rasterize.py; the
# maps stay exact through its fallback, at the fallback's cost).
STAT_RASTER_OVERFLOW = 6
N_STATS = 7


class FeatureState(NamedTuple):
    """Per-feature persistent filter state [N] (reference FeatureWithIDepth,
    flame/types.h)."""

    xy: jax.Array  # (N, 2) position in the anchor poseframe
    pf_slot: jax.Array  # (N,) int32 anchor poseframe slot
    idepth_mu: jax.Array  # (N,)
    idepth_var: jax.Array  # (N,)
    valid: jax.Array  # (N,) bool
    num_updates: jax.Array  # (N,) int32
    num_dropouts: jax.Array  # (N,) int32
    search_status: jax.Array  # (N,) int32 (last failure taxonomy)
    feat_id: jax.Array  # (N,) int32 globally-unique id (slots are recycled;
    # ids are not — BA landmarks key on id, reference feat.id flame.cc:740)


class CurrFeatures(NamedTuple):
    """Features projected into the current frame [N]
    (reference feats_in_curr_)."""

    xy: jax.Array  # (N, 2)
    idepth: jax.Array  # (N,)
    var: jax.Array  # (N,)
    valid: jax.Array  # (N,) bool


class TrackObs(NamedTuple):
    """Per-feature epipolar match observations from one update, the raw
    material for windowed BA (new vs reference, which exposes no
    per-match output)."""

    success: jax.Array  # (N,) bool — full track+measure+fuse success
    u_ref: jax.Array  # (N, 2) anchor-frame pixel (post any re-anchoring)
    u_obs: jax.Array  # (N, 2) matched pixel in the new frame
    idepth: jax.Array  # (N,) fused idepth (anchor frame)
    var: jax.Array  # (N,) fused variance


def empty_features(capacity: int) -> FeatureState:
    N = capacity
    return FeatureState(
        xy=jnp.zeros((N, 2), jnp.float32),
        pf_slot=jnp.zeros((N,), jnp.int32),
        idepth_mu=jnp.zeros((N,), jnp.float32),
        idepth_var=jnp.zeros((N,), jnp.float32),
        valid=jnp.zeros((N,), bool),
        num_updates=jnp.zeros((N,), jnp.int32),
        num_dropouts=jnp.zeros((N,), jnp.int32),
        search_status=jnp.zeros((N,), jnp.int32),
        feat_id=jnp.full((N,), -1, jnp.int32))


def _feature_geos(K, Kinv, stack: FrameStack, feats: FeatureState,
                  q_new, t_new):
    """Batched anchor->new epipolar geometries, one per feature."""
    qa = stack.q[feats.pf_slot]  # (N, 4) anchor camera-to-world
    ta = stack.t[feats.pf_slot]
    # T_ref_to_new = T_new^-1 * T_anchor.
    q_rel, t_rel = se3.mul(se3.inverse((q_new, t_new)), (qa, ta))
    return jax.vmap(epipolar.load, in_axes=(None, None, 0, 0))(
        K, Kinv, q_rel, t_rel)


@functools.partial(jax.jit, static_argnames=("params",))
def track_project_sync(params: Params, K, Kinv, stack: FrameStack,
                       feats: FeatureState, fnew: Frame, curr_pf_slot):
    """The per-frame feature update: track -> measure -> fuse -> project ->
    graph-membership gate. One fused jit over all feature slots.

    Returns (feats', curr: CurrFeatures, member: (N,) bool graph-membership
    mask, stats: (N_STATS,) int32 failure counters, obs: TrackObs — the
    per-feature match observations this frame (consumed by the BA layer).
    """
    N = feats.xy.shape[0]
    H, W = fnew.gradx.shape
    pad = (fnew.img_pad.shape[0] - H) // 2
    fp = params.fparams
    border = params.border
    row_offset = H // 3 if params.detection.do_letterbox else 0
    n_steps = line_stereo.n_steps_for(fp.epilength_max,
                                      fp.sparams.sample_dist)

    q_new, t_new = fnew.q, fnew.t
    geos = _feature_geos(K, Kinv, stack, feats, q_new, t_new)

    def vr_contains(xy):
        return ((xy[..., 0] >= border) & (xy[..., 0] < W - border)
                & (xy[..., 1] >= border + row_offset)
                & (xy[..., 1] < H - border - row_offset))

    alive = feats.valid

    # --- Baseline gate (flame.cc:1319-1324): too-small baseline = skip (not
    # a failure; feature state untouched this frame).
    baseline = jnp.linalg.norm(geos.t_ref_to_cmp, axis=-1)
    do_track = alive & (baseline >= params.min_baseline)

    # --- Predict (flame.cc:1550-1564).
    ok_pred, u_cmp_pred, mu_pred, var_pred = jax.vmap(
        idfilter.predict, in_axes=(0, None, 0, 0, 0))(
            geos, fp.process_var_factor, feats.xy, feats.idepth_mu,
            feats.idepth_var)

    # --- Rescale factor (flame.cc:1583-1659): out-of-bounds warp moves the
    # feature to the current poseframe and fails the track.
    rescale = jnp.where((feats.idepth_mu > 0) & (mu_pred > 0),
                        mu_pred / jnp.where(feats.idepth_mu > 0,
                                            feats.idepth_mu, 1.0), 1.0)
    bad_rescale = (rescale <= params.rescale_factor_min) | \
                  (rescale >= params.rescale_factor_max)

    # Move path: predict through anchor -> curr_pf. Composed from the
    # already-built anchor->new geometries and ONE new->pf geometry
    # instead of a second vmapped K R Kinv chain over all slots.
    q_pf = stack.q[curr_pf_slot]
    t_pf = stack.t[curr_pf_slot]
    geo_n2pf = epipolar.load(K, Kinv, *se3.mul(
        se3.inverse((q_pf, t_pf)), (q_new, t_new)))
    geos_mv = epipolar.compose(geo_n2pf, geos)
    ok_mv, u_pf, id_pf, _ = jax.vmap(
        idfilter.predict, in_axes=(0, None, 0, 0, 0))(
            geos_mv, fp.process_var_factor, feats.xy, feats.idepth_mu,
            feats.idepth_var)
    mv_in = vr_contains(u_pf)
    do_move = do_track & ok_pred & bad_rescale
    move_ok = do_move & ok_mv & mv_in
    move_fail = do_move & ~(ok_mv & mv_in)

    ratio_mv = jnp.where(jnp.abs(feats.idepth_mu) > 0,
                         id_pf / jnp.where(jnp.abs(feats.idepth_mu) > 0,
                                           feats.idepth_mu, 1.0), 1.0)
    vf4_mv = jnp.where(id_pf < 1e-6, 1.0, ratio_mv ** 4)

    new_xy = jnp.where(move_ok[:, None], u_pf, feats.xy)
    new_pf_slot = jnp.where(move_ok, jnp.asarray(curr_pf_slot, jnp.int32),
                            feats.pf_slot)
    new_mu = jnp.where(move_ok, id_pf, feats.idepth_mu)
    new_var = jnp.where(move_ok, feats.idepth_var * vf4_mv, feats.idepth_var)
    killed_by_move = move_fail

    # --- Search region (flame.cc:1661-1675), using the pre-update prior.
    attempt = do_track & ok_pred & ~bad_rescale
    reg = jax.vmap(
        functools.partial(idfilter.get_search_region, fp),
        in_axes=(0, None, None, 0, 0, 0))(
            geos, W, H, feats.xy, feats.idepth_mu, feats.idepth_var)
    in_vr = vr_contains(feats.xy)
    attempt = attempt & reg.ok & in_vr

    # --- Line search against the anchor pf image stack (flame.cc:1689-1694).
    off = jnp.float32(pad)
    sres = idfilter.search_stacked(
        fp, geos, rescale, stack.img_pad, feats.pf_slot, fnew.img_pad,
        feats.xy, feats.xy + off, reg.start + off, reg.end + off, n_steps,
        imgs_pack=stack.img_pack)
    flow = sres.u_cmp - off
    search_ok = attempt & (sres.status == idfilter.SUCCESS)

    # --- Measurement (flame.cc:1380-1390): cmp frame is fnew.
    ok_meas, mu_meas, var_meas = jax.vmap(
        functools.partial(meas_model.idepth_measurement, params.zparams),
        in_axes=(0, None, None, 0, 0))(
            geos, fnew.gradx, fnew.grady, feats.xy, flow)

    # --- Fusion with the anchor-frame prior (flame.cc:1433-1440).
    ok_fuse, mu_post, var_post = idfilter.update(
        new_mu, new_var, mu_meas, var_meas, params.outlier_sigma_thresh)

    success = search_ok & ok_meas & ok_fuse
    # Any attempted-but-failed lane (including move lanes) takes the failure
    # path; skipped lanes (baseline) remain untouched.
    attempted = do_track & ok_pred  # reached rescale/search logic
    failed = (do_track & ~ok_pred) | (attempted & ~success)

    if params.do_meas_fusion:
        mu_succ, var_succ = mu_post, var_post
    else:
        mu_succ, var_succ = mu_meas, var_meas

    out_mu = jnp.where(success, mu_succ, new_mu)
    out_var = jnp.where(success, var_succ,
                        jnp.where(failed,
                                  new_var * fp.process_fail_var_factor,
                                  new_var))

    fail_max_var = failed & (out_var > params.idepth_var_max)
    out_dropouts = jnp.where(success, 0,
                             jnp.where(failed, feats.num_dropouts + 1,
                                       feats.num_dropouts))
    fail_max_drop = failed & (out_dropouts > params.max_dropouts)

    out_valid = alive & ~killed_by_move & ~fail_max_var & ~fail_max_drop
    out_updates = jnp.where(success, feats.num_updates + 1,
                            feats.num_updates)
    out_status = jnp.where(attempt, sres.status, feats.search_status)

    feats2 = FeatureState(
        xy=new_xy, pf_slot=new_pf_slot, idepth_mu=out_mu,
        idepth_var=out_var, valid=out_valid,
        num_updates=out_updates.astype(jnp.int32),
        num_dropouts=out_dropouts.astype(jnp.int32),
        search_status=out_status.astype(jnp.int32),
        feat_id=feats.feat_id)

    # --- Project into the current frame (flame.cc:1754-1860). Anchors
    # changed only on moved lanes, where the new anchor IS curr_pf: select
    # the single pf->new geometry there instead of re-running the vmapped
    # geometry build over all slots.
    geo_pf2new = epipolar.load(K, Kinv, *se3.mul(
        se3.inverse((q_new, t_new)), (q_pf, t_pf)))

    def _sel(a, b):
        m = move_ok.reshape(move_ok.shape + (1,) * (a.ndim - 1))
        return jnp.where(m, jnp.broadcast_to(b, a.shape), a)

    geos2 = jax.tree.map(_sel, geos, geo_pf2new)
    xy_cur, id_cur = jax.vmap(epipolar.project_idepth)(
        geos2, feats2.xy, feats2.idepth_mu)
    proj_ok = vr_contains(xy_cur) & (id_cur >= 0)
    ratio_c = jnp.where(feats2.idepth_mu > 0,
                        id_cur / jnp.where(feats2.idepth_mu > 0,
                                           feats2.idepth_mu, 1.0), 1.0)
    # Guard on the PROJECTED idepth (like the move path above and
    # reanchor_features): a near-zero id_cur would otherwise give
    # vf4 ~ 0 and a spuriously certain var_cur ~ 0.
    vf4_c = jnp.where(id_cur < 1e-6, 1.0, ratio_c ** 4)
    var_cur = vf4_c * feats2.idepth_var

    final_valid = feats2.valid & proj_ok
    feats3 = feats2._replace(valid=final_valid)
    curr = CurrFeatures(xy=xy_cur, idepth=id_cur, var=var_cur,
                        valid=final_valid)

    # --- Graph membership gate (flame.cc:1956-1980): variance below the
    # graph threshold and world height within bounds (anchor-frame
    # backprojection; idepth 0 maps to infinity and fails the gate).
    qf = stack.q[feats3.pf_slot]
    tf = stack.t[feats3.pf_slot]
    rx = Kinv[0, 0] * feats3.xy[:, 0] + Kinv[0, 2]
    ry = Kinv[1, 1] * feats3.xy[:, 1] + Kinv[1, 2]
    ray = jnp.stack([rx, ry, jnp.ones_like(rx)], axis=-1)
    # idepth <= 0 maps to INFINITE depth (gate fails: the world point is
    # beyond any height bound); 1/where(mu>0, mu, inf) would instead put
    # it at the camera center, which normal flying heights ACCEPT.
    depth = jnp.where(feats3.idepth_mu > 0,
                      1.0 / jnp.where(feats3.idepth_mu > 0,
                                      feats3.idepth_mu, 1.0),
                      jnp.inf)
    p_world = se3.quat_rotate(qf, ray * depth[:, None]) + tf
    height_ok = ((-p_world[:, 1] >= params.min_height)
                 & (-p_world[:, 1] <= params.max_height))
    member = final_valid & (feats3.idepth_var < params.idepth_var_max_graph) \
        & height_ok

    if params.do_grad_check_after_projection:
        # Drop members that project onto gradient-free image regions
        # (reference projectGraph, flame.cc:1908-1918).
        from flame_tpu.ops import interp as _interp
        gx = _interp.bilinear(fnew.gradx, xy_cur[:, 0], xy_cur[:, 1])
        gy = _interp.bilinear(fnew.grady, xy_cur[:, 0], xy_cur[:, 1])
        member = member & (gx * gx + gy * gy
                           >= params.min_grad_mag * params.min_grad_mag)

    # --- Failure stats.
    stats = jnp.zeros((N_STATS,), jnp.int32)
    stats = stats.at[STAT_UPDATES].set(jnp.sum(success))
    stats = stats.at[STAT_FAIL_MAX_VAR].set(jnp.sum(fail_max_var))
    stats = stats.at[STAT_FAIL_MAX_DROPOUTS].set(jnp.sum(fail_max_drop))
    stats = stats.at[STAT_FAIL_REF_PATCH].set(
        jnp.sum(attempt & (sres.status == idfilter.FAIL_REF_PATCH_GRADIENT)))
    stats = stats.at[STAT_FAIL_AMBIGUOUS].set(
        jnp.sum(attempt & (sres.status == idfilter.FAIL_AMBIGUOUS_MATCH)))
    stats = stats.at[STAT_FAIL_MAX_COST].set(
        jnp.sum(attempt & (sres.status == idfilter.FAIL_MAX_COST)))

    obs = TrackObs(success=success & final_valid, u_ref=feats3.xy,
                   u_obs=flow, idepth=feats3.idepth_mu,
                   var=feats3.idepth_var)
    return feats3, curr, member, stats, obs


def insert_detections(params: Params, feats: FeatureState, det_out,
                      pf_slot, seed_map, id_base) -> FeatureState:
    """Insert detection winners into free feature slots ON DEVICE
    (reference flame.cc:737-757, where the detection thread hands winners
    back to update()). Device-side slot assignment removes the host
    round-trip from the feature lifecycle entirely: the r-th winner takes
    the r-th free slot via a rank->slot scatter table (no sort).

    det_out: (C, 3) [x, y, take] from detection.detect_packed.
    seed_map: dense idepthmap to seed new features from (NaN = use
    idepth_init; reference seeds from the poseframe's stashed map,
    flame.cc:747-753 — here the previous frame's map, one frame of motion
    away, with the same fallback).
    id_base: int32 scalar; winner r gets feat_id id_base + r.
    """
    N = feats.valid.shape[0]
    C = det_out.shape[0]
    take = det_out[:, 2] > 0
    xy = det_out[:, :2]

    free = ~feats.valid
    frank = jnp.cumsum(free.astype(jnp.int32)) - 1  # rank among free slots
    n_free = frank[-1] + 1
    # rank -> slot table (out-of-range ranks dropped).
    table = jnp.zeros((N,), jnp.int32).at[
        jnp.where(free, frank, N)].set(jnp.arange(N, dtype=jnp.int32),
                                       mode="drop")
    wrank = jnp.cumsum(take.astype(jnp.int32)) - 1  # rank among winners
    use = take & (wrank < n_free)
    slot = table[jnp.clip(wrank, 0, N - 1)]
    # Unused rows scatter out-of-bounds (dropped) — no duplicate-index
    # write races on slot 0.
    slot = jnp.where(use, slot, N)

    H, W = seed_map.shape
    xi = jnp.clip(jnp.floor(xy[:, 0] + 0.5).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.floor(xy[:, 1] + 0.5).astype(jnp.int32), 0, H - 1)
    seed = seed_map[yi, xi]
    mu = jnp.where(jnp.isnan(seed), params.idepth_init, seed)

    def scat(arr, vals):
        return arr.at[slot].set(vals, mode="drop")

    zc = jnp.zeros((C,), jnp.int32)
    return FeatureState(
        xy=scat(feats.xy, xy),
        pf_slot=scat(feats.pf_slot, jnp.broadcast_to(
            jnp.asarray(pf_slot, jnp.int32), (C,))),
        idepth_mu=scat(feats.idepth_mu, mu),
        idepth_var=scat(feats.idepth_var,
                        jnp.full((C,), params.idepth_var_init, jnp.float32)),
        valid=scat(feats.valid, jnp.ones((C,), bool)),
        num_updates=scat(feats.num_updates, zc),
        num_dropouts=scat(feats.num_dropouts, zc),
        search_status=scat(feats.search_status, zc),
        feat_id=scat(feats.feat_id,
                     jnp.asarray(id_base, jnp.int32)
                     + jnp.arange(C, dtype=jnp.int32)))


def _detect_and_insert(params: Params, K, Kinv, stack: FrameStack,
                       curr_pf_slot, feats3: FeatureState,
                       curr: CurrFeatures, fnew: Frame, prev_q, prev_t,
                       id_base, seed_map) -> FeatureState:
    """Poseframe detection + device-side winner insertion (the detection
    block shared by every per-frame body — one definition)."""
    from flame_tpu.core import detection

    H, W = fnew.gradx.shape
    row_offset = H // 3 if params.detection.do_letterbox else 0
    if params.photo_error_num_pfs > 0:
        # Best-comparison-poseframe selection (reference getPoseFrame,
        # flame.cc:775-820): score up to photo_error_num_pfs past
        # poseframes and use the winner's pose for the detection
        # epipolar direction, falling back to the previous frame when
        # no scored candidate survives. (The reference's live grid
        # detector derives its epiline from the previous frame,
        # flame.cc:1206-1209 — the selected frame fed only the
        # commented-out photometric detector — so using the winner
        # here is a strict robustness improvement: detection keeps a
        # usable baseline even when the previous frame is nearly
        # coincident with the poseframe.)
        from flame_tpu.core import keyframe
        cq, ct, cok = keyframe.best_comparison_pose(
            W, H, K, Kinv, stack.q, stack.t, stack.frame_id,
            stack.valid, curr_pf_slot, params.photo_error_num_pfs)
        cmp_q = jnp.where(cok, cq, prev_q)
        cmp_t = jnp.where(cok, ct, prev_t)
    else:
        cmp_q, cmp_t = prev_q, prev_t
    geo = epipolar.load_relative(
        K, Kinv, (stack.q[curr_pf_slot], stack.t[curr_pf_slot]),
        (cmp_q, cmp_t))
    det_out = detection.detect_packed(
        geo, stack.gradx[curr_pf_slot], stack.grady[curr_pf_slot],
        curr.xy, curr.valid, params.detection.min_grad_mag,
        params.detection.win_size, params.border, row_offset)
    return insert_detections(params, feats3, det_out, curr_pf_slot,
                             seed_map, id_base)


def _frame_inner(params: Params, K, Kinv, stack: FrameStack,
                 feats: FeatureState, fnew: Frame, curr_pf_slot,
                 do_detect: bool, prev_q, prev_t, id_base, seed_map):
    """track_project_sync + (optional) poseframe detection + device-side
    winner insertion — the shared per-frame body of track_step /
    frame_track_step / batch_step (one definition; silent divergence
    between the call sites would otherwise be invisible)."""
    feats3, curr, member, stats, obs = track_project_sync.__wrapped__(
        params, K, Kinv, stack, feats, fnew, curr_pf_slot)
    if do_detect:
        feats3 = _detect_and_insert(params, K, Kinv, stack, curr_pf_slot,
                                    feats3, curr, fnew, prev_q, prev_t,
                                    id_base, seed_map)
    return feats3, curr, member, stats, obs


@functools.partial(jax.jit, static_argnames=("params", "do_detect"))
def track_step(params: Params, K, Kinv, stack: FrameStack,
               feats: FeatureState, fnew: Frame, curr_pf_slot,
               prev_q=None, prev_t=None, do_detect: bool = False,
               id_base=0, seed_map=None):
    """track_project_sync + (optional) poseframe detection + device-side
    winner insertion + output packing fused into ONE dispatch, so the
    per-frame hot path dispatches exactly once here.

    Returns (feats', curr, member, stats, obs, packed) where packed is the
    single (N, 3) uint16 device->host transfer. Detection winners are
    inserted into free slots on device (insert_detections) — the host
    learns the new occupancy from the packed flags when the transfer
    lands, so detection never couples to the fetch cadence.
    """
    feats3, curr, member, stats, obs = _frame_inner(
        params, K, Kinv, stack, feats, fnew, curr_pf_slot, do_detect,
        prev_q, prev_t, id_base, seed_map)
    packed = pack_track_outputs(feats3, curr, member)
    if params.do_ba:
        packed = pack_ba_outputs(params, packed, obs, feats3, stack)
    return feats3, curr, member, stats, obs, packed


@functools.partial(jax.jit, static_argnames=("params", "do_detect",
                                             "do_insert", "height",
                                             "width"))
def frame_track_step(params: Params, K, Kinv, stack: FrameStack,
                     feats: FeatureState, img, frame_id, q, t,
                     curr_pf_slot, prev_q, prev_t, id_base, seed_map,
                     do_detect: bool, do_insert: bool,
                     height: int = 0, width: int = 0):
    """Steady-state per-frame fast path: frame creation (pad + central
    gradients, from a raw image or the leading bytes of a coalesced
    upload), optional poseframe-stack insertion, and the fused
    track/detect/pack step — ONE device dispatch where the orchestrator
    previously issued three (create, insert, track). Returns
    (fnew, stack' or None, feats', curr, member, stats, obs, packed);
    stack' is returned only when do_insert (an unchanged 100 MB stack
    output would otherwise be copied every frame)."""
    from flame_tpu.core import frame as frame_mod

    if img.ndim == 1:
        fnew = frame_mod.create_from_buf.__wrapped__(
            frame_id, q, t, img, height, width, params.pad)
    else:
        fnew = frame_mod.create.__wrapped__(frame_id, q, t, img, params.pad)
    if do_insert:
        stack = frame_mod.insert.__wrapped__(stack, curr_pf_slot, fnew)

    feats3, curr, member, stats, obs = _frame_inner(
        params, K, Kinv, stack, feats, fnew, curr_pf_slot, do_detect,
        prev_q, prev_t, id_base, seed_map)
    packed = pack_track_outputs(feats3, curr, member)
    if params.do_ba:
        packed = pack_ba_outputs(params, packed, obs, feats3, stack)
    return (fnew, stack if do_insert else None, feats3, curr, member,
            stats, obs, packed)


@functools.partial(jax.jit, static_argnames=("params",))
def bootstrap_detect(params: Params, K, Kinv, stack: FrameStack,
                     feats: FeatureState, prev_q, prev_t, pf_slot,
                     seed_map, id_base, curr_xy, curr_valid):
    """First-poseframe detection + insertion, one dispatch (reference
    flame.cc:174-242). Returns (feats', valid mask) — the caller fetches
    the mask once to prime the host mirror."""
    from flame_tpu.core import detection

    H = stack.gradx.shape[1]
    row_offset = H // 3 if params.detection.do_letterbox else 0
    geo = epipolar.load_relative(
        K, Kinv, (stack.q[pf_slot], stack.t[pf_slot]), (prev_q, prev_t))
    det_out = detection.detect_packed(
        geo, stack.gradx[pf_slot], stack.grady[pf_slot],
        curr_xy, curr_valid, params.detection.min_grad_mag,
        params.detection.win_size, params.border, row_offset)
    feats2 = insert_detections(params, feats, det_out, pf_slot, seed_map,
                               id_base)
    return feats2, feats2.valid


def _graph_sync_inner(params: Params, graph: nltgv2.GraphState,
                      prev_in_graph, member, curr: CurrFeatures,
                      geo_prev_to_new: epipolar.EpiGeo, graph_scale,
                      topo, prev_idepthmap=None):
    """Synchronize the solver graph with the tracked features
    (reference projectGraph flame.cc:1862-1938 + syncGraph :1940-2163).

    prev_in_graph: (N,) bool — membership before this frame.
    member: (N,) bool — membership after gating.
    topo: optimize.topology.Topology with the new edge set and duals
    already carried over (reference flame.cc:2094-2104 keeps duals on
    surviving vertex pairs).
    """
    # Project surviving vertices' smoothed idepth into the new frame
    # (projectGraph transforms x through the prev->new geometry; position is
    # subsequently overwritten with the feature's current projection).
    x_proj, id_new = epipolar.project_idepth(
        geo_prev_to_new, graph.pos, graph.x * graph_scale)
    x_surv = jnp.where(prev_in_graph, id_new / graph_scale, graph.x)

    new_member = member & ~prev_in_graph
    data_term = curr.idepth / graph_scale
    weight = jnp.where(
        member,
        (1.0 / jnp.maximum(curr.var, 1e-12))
        if params.adaptive_data_weights else jnp.ones_like(curr.var),
        0.0)
    if params.rescale_data:
        # Cumulative data_factor scaling (reference flame.cc:349) folds into
        # the dynamic per-vertex weight: lambda_eff = data_factor * scale.
        weight = weight * graph_scale

    if params.init_with_prediction and prev_idepthmap is not None:
        # Initialize new vertices from the previous dense idepthmap when
        # it has a value there; where it is NaN, fall back to the mean
        # smoothed idepth of the vertex's surviving graph neighbors, then
        # to the data term (reference flame.cc:2132-2158). The reference
        # walks feats_to_update sequentially so an earlier-initialized
        # new vertex can feed a later one; here all new vertices
        # initialize in parallel from the survivors only.
        H, W = prev_idepthmap.shape
        xi = jnp.clip(jnp.floor(curr.xy[:, 0] + 0.5).astype(jnp.int32),
                      0, W - 1)
        yi = jnp.clip(jnp.floor(curr.xy[:, 1] + 0.5).astype(jnp.int32),
                      0, H - 1)
        pred = prev_idepthmap[yi, xi] / graph_scale

        V = graph.x.shape[0]
        lo = topo.edges[:, 0]
        hi = topo.edges[:, 1]
        good = prev_in_graph & member  # qualified neighbor (weight > 0)
        w_lo = (topo.edge_mask & good[hi]).astype(jnp.float32)
        w_hi = (topo.edge_mask & good[lo]).astype(jnp.float32)
        num = jax.ops.segment_sum(w_lo * x_surv[hi], lo, num_segments=V) \
            + jax.ops.segment_sum(w_hi * x_surv[lo], hi, num_segments=V)
        den = jax.ops.segment_sum(w_lo, lo, num_segments=V) \
            + jax.ops.segment_sum(w_hi, hi, num_segments=V)
        nb_mean = num / jnp.maximum(den, 1.0)
        fallback = jnp.where(den > 0, nb_mean, data_term)
        init_x = jnp.where(jnp.isnan(pred), fallback, pred)
    else:
        init_x = data_term

    x = jnp.where(new_member, init_x, x_surv)
    if params.check_sticky_obstacles:
        sticky = member & (x - data_term > 0.25)
        x = jnp.where(sticky, data_term, x)
    x_bar = jnp.where(new_member, x, graph.x_bar)
    w1 = jnp.where(new_member, 0.0, graph.w1)
    w2 = jnp.where(new_member, 0.0, graph.w2)
    w1_bar = jnp.where(new_member, 0.0, graph.w1_bar)
    w2_bar = jnp.where(new_member, 0.0, graph.w2_bar)

    return graph._replace(
        pos=jnp.where(member[:, None], curr.xy, graph.pos),
        x=jnp.where(member, x, 0.0),
        w1=jnp.where(member, w1, 0.0),
        w2=jnp.where(member, w2, 0.0),
        x_bar=jnp.where(member, x_bar, 0.0),
        w1_bar=jnp.where(member, w1_bar, 0.0),
        w2_bar=jnp.where(member, w2_bar, 0.0),
        data_term=jnp.where(member, data_term, 0.0),
        data_weight=weight,
        vtx_mask=member,
        edges=topo.edges,
        alpha=topo.alpha,
        beta=jnp.where(topo.edge_mask, 1.0, 0.0),
        q1=topo.q1, q2=topo.q2, q3=topo.q3,
        edge_mask=topo.edge_mask,
        inc_edge=topo.inc_edge, inc_sign=topo.inc_sign,
        src_slot=topo.src_slot)


SMOOTHERS = ("auto", "vertex", "halo")


def resolve_smoother(params: Params, mesh=None) -> str:
    """The smoother this configuration runs: the XLA vertex-centric
    formulation (nltgv2._smooth_vertex_centric) for "auto" and "vertex",
    or "halo" — vertex-partitioned over a device mesh with ppermute
    boundary exchange (parallel/halo.py) — which needs `mesh`."""
    mode = params.solver.smoother
    if mode not in SMOOTHERS:
        raise ValueError(f"smoother={mode!r}; valid modes: {SMOOTHERS}")
    if mode == "halo" and mesh is None:
        raise ValueError("smoother='halo' needs a device mesh; use "
                         "parallel.orchestrator.ShardedFlame")
    return "vertex" if mode == "auto" else mode


def _post_delaunay_inner(params: Params, K, Kinv, graph: nltgv2.GraphState,
                         member, curr: CurrFeatures,
                         pose_prev, pose_new, graph_scale,
                         width: int, height: int,
                         prev_idepthmap=None, topo_buf=None,
                         tris=None, n_tris=None, edges=None, n_edges=None,
                         edge_ranks=None, topo_offset: int = 0,
                         carry_fresh=None, mesh=None):
    """Everything between host Delaunay and the next frame, fused into ONE
    dispatch: prev->new epipolar geometry, device-side edge topology + dual
    carry (from the uploaded triangle array alone), graph synchronization,
    K smoothing iterations, mesh outputs, and the coverage stat. Returns
    (graph', vtx_idepths, normals, tri_validity, idepthmap, graph_scale,
    coverage). pose_prev/pose_new are (q, t) camera-to-world.

    Topology comes either as topo_buf — the production path's single
    packed u16 upload [n_tris, n_edges | tris flat (T, 3) | edge_src into
    the 3T directed edges | ranks | carry | perm (halo mode)] — or as
    separate tris/edges/ranks arrays. The ranks segment carries incidence
    slot ranks (lo | hi << 8) in vertex-smoother mode and RCM-space edge
    ranks (sr | dr << 8) in halo mode; perm is the RCM rank -> vertex-slot
    permutation.

    mesh: a jax.sharding.Mesh (static), required by the halo smoother
    (ppermute boundary strips, parallel/halo.py); its axis name must be
    parallel.sharding.AXIS."""
    from flame_tpu.optimize import topology as topo_mod

    geo_prev_to_new = epipolar.load_relative(K, Kinv, pose_prev, pose_new)

    V = graph.x.shape[0]
    E = graph.q1.shape[0]
    D = graph.inc_edge.shape[1]
    smoother = resolve_smoother(params, mesh)
    # The halo smoother builds its own rank layout from the RCM perm and
    # RCM-space ranks, so the [V, D] incidence build (2 big scatters) is
    # skipped entirely.
    rank_layout = smoother == "halo"

    perm = None
    carry_idx = None
    if topo_buf is not None and topo_buf.dtype == jnp.uint8:
        # Coalesced upload: the u16 topology words ride behind the frame's
        # image bytes in one transfer; split + bitcast on device.
        topo_buf = jax.lax.bitcast_convert_type(
            topo_buf[topo_offset:].reshape(-1, 2), jnp.uint16)
    if topo_buf is not None:
        T = params.triangle_capacity
        assert E == params.edge_capacity
        n_tris = topo_buf[0].astype(jnp.int32)
        n_edges = topo_buf[1].astype(jnp.int32)
        tris = topo_buf[2: 2 + 3 * T].reshape(T, 3).astype(jnp.int32)
        edge_src = topo_buf[2 + 3 * T: 2 + 3 * T + E].astype(jnp.int32)
        rk = topo_buf[2 + 3 * T + E: 2 + 3 * T + 2 * E].astype(jnp.int32)
        edge_ranks = jnp.stack([rk & 0xFF, rk >> 8], axis=1)
        carry_idx = topo_buf[2 + 3 * T + 2 * E: 2 + 3 * T + 3 * E] \
            .astype(jnp.int32)
        if rank_layout:
            perm = topo_buf[2 + 3 * T + 3 * E:].astype(jnp.int32)
        # Directed corner edges -> the host-selected unique occurrence.
        a = tris.reshape(-1)
        b = tris[:, jnp.array([1, 2, 0])].reshape(-1)
        dlh = jnp.stack([jnp.minimum(a, b), jnp.maximum(a, b)], axis=1)
        edges = dlh[edge_src]  # (E, 2) canonical (lo, hi), code-sorted

    if edges is not None:
        topo = topo_mod.from_edges(
            edges, n_edges, curr.xy, graph.edges, graph.edge_mask,
            graph.q1, graph.q2, graph.q3, E, V, D,
            build_incidence=not rank_layout,
            ranks=None if rank_layout else edge_ranks,
            carry_idx=carry_idx, carry_fresh=carry_fresh)
    else:
        topo = topo_mod.from_triangles(
            tris, n_tris, curr.xy, graph.edges, graph.edge_mask,
            graph.q1, graph.q2, graph.q3, E, V, D,
            build_incidence=not rank_layout)

    # Under async topology the triangle set lags membership by one frame;
    # mask out edges touching vertices that left the graph.
    edge_ok = topo.edge_mask & member[topo.edges[:, 0]] \
        & member[topo.edges[:, 1]]
    topo = topo._replace(edge_mask=edge_ok,
                         alpha=jnp.where(edge_ok, topo.alpha, 0.0),
                         q1=jnp.where(edge_ok, topo.q1, 0.0),
                         q2=jnp.where(edge_ok, topo.q2, 0.0),
                         q3=jnp.where(edge_ok, topo.q3, 0.0))

    graph = _graph_sync_inner(params, graph, graph.vtx_mask, member, curr,
                              geo_prev_to_new, graph_scale, topo,
                              prev_idepthmap)

    if params.rescale_data:
        # Renormalize the graph so x stays O(1) (reference flame.cc:328-351):
        # new scale = mean raw idepth of the data terms; primal state and
        # data terms divide by the ratio. The reference also scales
        # data_factor cumulatively; here that folds into data_weight (see
        # _graph_sync_inner).
        cnt = jnp.maximum(jnp.sum(member.astype(jnp.float32)), 1.0)
        new_scale = jnp.sum(jnp.where(member, graph.data_term, 0.0)) \
            * graph_scale / cnt
        new_scale = jnp.where(new_scale > 1e-8, new_scale, graph_scale)
        ratio = graph_scale / new_scale
        graph = graph._replace(
            x=graph.x * ratio, x_bar=graph.x_bar * ratio,
            data_term=graph.data_term * ratio)
        graph_scale = new_scale

    if params.do_nltgv2:
        if rank_layout:
            if perm is None:
                # The incidence tables were skipped above; the vertex
                # smoother would smooth against zeroed neighbor tables.
                raise ValueError("smoother='halo' needs the perm segment "
                                 "of the packed topo_buf")
            # Vertex-partitioned over the mesh with boundary halo exchange
            # per iteration (SURVEY.md section 2b).
            from flame_tpu.parallel import halo as halo_mod
            inv_perm = jnp.zeros((V,), jnp.int32).at[perm].set(
                jnp.arange(V, dtype=jnp.int32))
            graph = halo_mod.halo_smooth(
                params.rparams, graph, perm, inv_perm, edge_ranks,
                params.solver.n_iters_per_frame,
                params.solver.max_vertex_degree, mesh,
                halo=halo_mod.strip_width(V, int(mesh.devices.size),
                                          params.solver.pallas_reach))
        else:
            graph = nltgv2.smooth(params.rparams, graph,
                                  params.solver.n_iters_per_frame,
                                  mode="vertex")
    else:
        graph = graph._replace(x=graph.data_term)

    tris32 = tris.astype(jnp.int32)
    tri_mask = (jnp.arange(tris.shape[0]) < n_tris) \
        & jnp.all(member[tris32], axis=1)
    outs = mesh_outputs(params, K, Kinv, width, height, graph,
                        tris32, tri_mask, graph_scale)
    coverage = jnp.mean((~jnp.isnan(outs[-1])).astype(jnp.float32))
    return (graph,) + outs + (jnp.asarray(graph_scale, jnp.float32),
                              coverage)


post_delaunay_step = functools.partial(
    jax.jit, static_argnames=("params", "width", "height",
                              "topo_offset", "mesh"))(_post_delaunay_inner)


@functools.partial(jax.jit, static_argnames=("params", "n_frames",
                                             "height", "width", "mesh"))
def batch_step(params: Params, K, Kinv, stack: FrameStack,
               feats: FeatureState, graph: nltgv2.GraphState, graph_scale,
               buf, fids, qs, ts, pf_flags, det_flags, pf_slots, id_bases,
               prev_q, prev_t, sync_prev_q, sync_prev_t, seed_map,
               carry_fresh, n_frames: int = 2, height: int = 0,
               width: int = 0, imgs=None, mesh=None):
    """N frames per device dispatch: a lax.scan over the per-frame body
    (create -> [poseframe insert] -> track -> [detect] -> dense
    rasterization) followed by one post-Delaunay section (topology decode
    + graph sync + smoothing + mesh outputs) on the last frame's state —
    all fused into ONE dispatch.

    Rationale: dividing dispatches and uploads by n_frames divides the
    per-dispatch fixed cost (launch, host bookkeeping, transfers) by the
    same factor. Each frame's tracking/measurement/
    fusion semantics are EXACTLY the sequential per-frame semantics (the
    scan shares one compiled body, not one set of measurements); only the
    SMOOTHING cadence becomes per-batch — the reference's free-running
    graph thread likewise decouples smoothing from the camera rate
    (flame.cc:98-112). The dense idepthmap stays PER-FRAME (the reference
    rasterizes inside every update(), flame.cc:409-415): each scanned
    frame projects the batch-start mesh into its own view and rasterizes
    it; the per-frame map seeds that frame's detection and is stashed
    into the poseframe stack, and the post-smoothing map of the last
    frame is the batch's output. Output latency grows by n_frames-1
    frames.

    Versus a static n_frames-fold unroll (the old pair_step), the scan
    compiles the body ONCE (cold-compile time is ~independent of
    n_frames) and the poseframe/detection pattern is DATA (pf_flags /
    det_flags), so every batch shape shares one executable instead of
    compiling per static flag combination.

    buf: ONE coalesced uint8 upload [img_0 | ... | img_{B-1} | topology
    words (u16 view, layout of flame._host_triangulate; re-uploaded each
    batch)].
    imgs: alternatively (device-resident ingestion, e.g. a DMA/PCIe
    camera feed or the bench's pre-staged frames), a length-B tuple of
    (H, W) uint8 DEVICE arrays; buf then carries only the topology
    words. Passing imgs=None vs a tuple selects the executable via the
    argument pytree structure — no extra static flag.
    qs/ts: length-B tuples of (4,)/(3,) pose arrays (stacked inside the
    jit — stacking eagerly would cost an extra dispatch).
    pf_slots[b]: the current poseframe slot DURING frame b's tracking.
    prev_q/prev_t: pose of the frame before the batch (frame 0's
    detection comparison frame); frame b's is frame b-1. sync_prev_q/t:
    pose of the frame whose pixel coordinates the graph currently holds
    (the previous batch's last frame).

    Returns (fnew_last, stack', feats', curr_last, member_last, stats,
    obs_stacked, packed, graph', vtx_idepths, normals, tri_validity,
    idepthmap, graph_scale', coverage); obs_stacked is the per-frame
    TrackObs pytree with a leading (n_frames,) axis (BA ingests the
    poseframe rows).
    """
    from flame_tpu.core import frame as frame_mod
    from flame_tpu.ops import rasterize as raster

    B = n_frames
    hw = height * width
    pad = params.pad

    qs = jnp.stack([q.astype(jnp.float32) for q in qs])
    ts = jnp.stack([t.astype(jnp.float32) for t in ts])
    if imgs is not None:
        imstack = jnp.stack([im.reshape(height, width) for im in imgs])
        topo_offset = 0
    else:
        imstack = buf[: B * hw].reshape(B, height, width)
        topo_offset = B * hw

    # Decode the batch's triangle set up front: the per-frame dense
    # rasterization below draws the same triangles the post-Delaunay
    # section will apply (the duplicate decode is CSE'd — batch_step is
    # one jit).
    T = params.triangle_capacity
    tb = buf
    if tb.dtype == jnp.uint8:
        tb = jax.lax.bitcast_convert_type(
            tb[topo_offset:].reshape(-1, 2), jnp.uint16)
    n_tris_pre = tb[0].astype(jnp.int32)
    tris_pre = tb[2: 2 + 3 * T].reshape(T, 3).astype(jnp.int32)
    tri_in_pre = jnp.arange(T) < n_tris_pre
    vtx_x_pre = graph.x * graph_scale  # batch-start smoothed idepths
    sync_q32 = sync_prev_q.astype(jnp.float32)
    sync_t32 = sync_prev_t.astype(jnp.float32)

    # Per-frame dense idepthmaps (reference flame.cc:409-415 rasterizes
    # inside EVERY update): project the batch-start mesh (vertex pixels
    # live in the sync frame — the previous batch's last frame) into
    # each frame's view and rasterize ALL B maps up front in one call
    # (rasterize_batch). Smoothing staleness is at most one batch;
    # geometry is current per frame.
    def project_view(q, t):
        geo = epipolar.load_relative(K, Kinv, (sync_q32, sync_t32), (q, t))
        pos_b, id_b = epipolar.project_idepth(geo, graph.pos, vtx_x_pre)
        ok = graph.vtx_mask & (id_b > 0)
        return pos_b, id_b, ok

    pos_views, id_views, ok_views = jax.vmap(project_view)(qs, ts)
    tri_ok_views = tri_in_pre[None] & jnp.all(ok_views[:, tris_pre], axis=2)
    dense_views, raster_overflow = raster.rasterize_batch(
        pos_views, tris_pre, id_views, tri_ok_views, height, width)
    # Frame b's detection seeds from frame b-1's map (frame 0 from the
    # previous batch's output map), exactly as the sequential path.
    seed_views = jnp.concatenate([seed_map[None], dense_views[:-1]], axis=0)

    # Large per-frame products (Frame pytree, curr, member, dense map)
    # ride the CARRY — only obs (consumed per-frame by BA) and the tiny
    # stats vector are stacked scan outputs (stacking B frame pyramids
    # was pure device-memory write traffic).
    N = feats.xy.shape[0]
    f_shape = jax.eval_shape(
        lambda im: frame_mod.create.__wrapped__(
            jnp.int32(0), qs[0], ts[0], im, pad), imstack[0])
    f_init = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), f_shape)
    curr_init = CurrFeatures(xy=jnp.zeros((N, 2), jnp.float32),
                             idepth=jnp.zeros((N,), jnp.float32),
                             var=jnp.zeros((N,), jnp.float32),
                             valid=jnp.zeros((N,), bool))
    member_init = jnp.zeros((N,), bool)

    def body(carry, x):
        stack, feats, pq, pt, _f, _curr, _member = carry
        img, fid, q, t, pf, det, slot, id_base, dense, seed = x
        f = frame_mod.create.__wrapped__(fid, q, t, img, pad)
        # Masked one-row insert, NOT lax.cond(insert): XLA cannot alias
        # a cond's carry operands across branches, so the cond form
        # copied the full stack every scan iteration.
        stack = frame_mod.insert_masked.__wrapped__(stack, slot, f, pf)
        feats, curr, member, stats, obs = _frame_inner(
            params, K, Kinv, stack, feats, f, slot, False, pq, pt,
            id_base, seed)
        feats = jax.lax.cond(
            det,
            lambda fs: _detect_and_insert(params, K, Kinv, stack, slot,
                                          fs, curr, f, pq, pt, id_base,
                                          seed),
            lambda fs: fs, feats)
        # Stash this frame's OWN map into the stack when it is a
        # poseframe (reference flame.cc:417-428).
        stack = frame_mod.set_idepthmap_masked.__wrapped__(
            stack, slot, dense, pf)
        return (stack, feats, q, t, f, curr, member), (obs, stats)

    xs = (imstack,
          jnp.asarray(fids, jnp.int32), qs, ts,
          jnp.asarray(pf_flags, bool), jnp.asarray(det_flags, bool),
          jnp.asarray(pf_slots, jnp.int32),
          jnp.asarray(id_bases, jnp.int32),
          dense_views, seed_views)
    init = (stack, feats, prev_q.astype(jnp.float32),
            prev_t.astype(jnp.float32), f_init, curr_init, member_init)
    (stack, feats, _, _, f_last, curr, member), \
        (obs_b, stats_b) = jax.lax.scan(body, init, xs)
    dense_last = dense_views[-1]

    stats = stats_b.sum(axis=0)
    stats = stats.at[STAT_RASTER_OVERFLOW].add(raster_overflow)
    packed = pack_track_outputs.__wrapped__(feats, curr, member)
    if params.do_ba:
        packed = pack_ba_outputs(params, packed, obs_b, feats, stack)

    (graph, vtx_idepths, normals, tri_validity, idepthmap, graph_scale,
     coverage) = _post_delaunay_inner(
        params, K, Kinv, graph, member, curr,
        (sync_prev_q, sync_prev_t), (f_last.q, f_last.t), graph_scale,
        width, height,
        dense_last if params.init_with_prediction else None,
        topo_buf=buf, topo_offset=topo_offset, carry_fresh=carry_fresh,
        mesh=mesh)

    return (f_last, stack, feats, curr, member, stats, obs_b, packed,
            graph, vtx_idepths, normals, tri_validity, idepthmap,
            graph_scale, coverage)


# Fixed-point scale for packed pixel coordinates: 1/32 px resolution, max
# coordinate 2047 px — plenty for the Delaunay/occupancy decisions the host
# makes from them (detection winners are integer pixels, exact at /32).
PACK_XY_SCALE = 32.0
# Flag bits in the packed third channel.
PACK_MEMBER = 1
PACK_CURR_VALID = 2
PACK_FEAT_VALID = 4


@jax.jit
def pack_track_outputs(feats: FeatureState, curr: CurrFeatures, member):
    """Pack everything the host needs after tracking into one SMALL (N, 3)
    uint16 array (ONE device->host transfer per frame): per-feature
    [x*32, y*32, flags]."""
    def fx(v):
        return jnp.clip(v * PACK_XY_SCALE + 0.5, 0, 65535).astype(jnp.uint16)

    flags = (member.astype(jnp.uint16) * PACK_MEMBER
             | curr.valid.astype(jnp.uint16) * PACK_CURR_VALID
             | feats.valid.astype(jnp.uint16) * PACK_FEAT_VALID)
    return jnp.stack([fx(curr.xy[:, 0]), fx(curr.xy[:, 1]), flags], axis=1)


# Sentinel u_obs.x value marking a failed match in the BA section of the
# packed transfer (valid coordinates clip to 65534).
PACK_BA_FAIL = 0xFFFF


def pack_ba_outputs(params: Params, packed, obs: TrackObs,
                    feats: FeatureState, stack: FrameStack) -> jax.Array:
    """Widen the packed track transfer with everything the windowed-BA
    host layer needs, as ONE flat int32 array (ONE device->host transfer
    instead of a blocking fetch per array per poseframe).

    Layout (int32 words; N = feature capacity, B = frames in the
    dispatch, P = poseframe capacity):
      [ packed u16 (N, 3) bitcast          : 3N/2
      | u_obs u16 (B, N, 2) bitcast        : BN
        [x, y] * PACK_XY_SCALE fixed point; x == PACK_BA_FAIL marks a
        failed match
      | feats.xy u16 (N, 2) bitcast        : N  (the batch's u_ref)
      | idepth_mu f32 (N,) bitcast         : N
      | id_slot (N,)                       : N  (pf_slot << 24 | feat_id)
      | stack.frame_id (P,)                : P
      | stack.q f32 (P, 4) bitcast         : 4P
      | stack.t f32 (P, 3) bitcast         : 3P ]
    The host side (ba.window.split_packed) views the slices back.

    Everything except u_obs is the POST-DISPATCH snapshot — including
    the anchor pixel u_ref (feats.xy), sent ONCE per dispatch instead
    of per frame (a per-frame u_ref would double the BA bytes). For a
    feature re-anchored MID-batch this pairs earlier
    frames' observations with the new anchor's id AND pixel — a
    self-consistent (anchor, u_ref, idepth) triple (the r3 code paired
    the new anchor id with the OLD pixel). Requires N even (u16-pair
    bitcasts) and poseframe_capacity <= 128 (id_slot packing; checked
    at Flame.__init__). feat_ids ride mod 2^24: a collision needs two
    features ~14M ids (~10k poseframes of detections) apart, far beyond
    the observation ring buffer's horizon, and the device-side identity
    guard at write-back compares the same masked id."""
    if obs.u_ref.ndim == 2:  # single-frame dispatch -> B = 1
        obs = jax.tree.map(lambda a: a[None], obs)

    def u16pair_to_i32(a):
        # Direct bitcast (NOT astype: a value convert would mangle pairs
        # whose high u16 sets the sign bit).
        return jax.lax.bitcast_convert_type(a.reshape(-1, 2), jnp.int32)

    def f32_to_i32(a):
        return jax.lax.bitcast_convert_type(
            a.reshape(-1).astype(jnp.float32), jnp.int32)

    def fx(v):
        return jnp.clip(v * PACK_XY_SCALE + 0.5, 0, 65534).astype(jnp.uint16)

    uox = jnp.where(obs.success, fx(obs.u_obs[..., 0]),
                    jnp.uint16(PACK_BA_FAIL))
    uo = jnp.stack([uox, fx(obs.u_obs[..., 1])], axis=-1)  # (B, N, 2) u16
    xy = jnp.stack([fx(feats.xy[:, 0]), fx(feats.xy[:, 1])], axis=-1)
    id_slot = (feats.pf_slot.astype(jnp.int32) << 24) \
        | (feats.feat_id.astype(jnp.int32) & 0xFFFFFF)
    return jnp.concatenate([
        u16pair_to_i32(packed),
        u16pair_to_i32(uo),
        u16pair_to_i32(xy),
        f32_to_i32(feats.idepth_mu),
        id_slot,
        stack.frame_id.astype(jnp.int32),
        f32_to_i32(stack.q),
        f32_to_i32(stack.t)])


@functools.partial(jax.jit, static_argnames=("params", "width", "height"))
def mesh_outputs(params: Params, K, Kinv, width: int, height: int,
                 graph, tris, tri_mask, graph_scale):
    """Vertex idepths, normals, triangle filters, dense idepthmap — one
    fused dispatch (reference flame.cc:353-415)."""
    from flame_tpu.mesh import filters as mesh_filters
    from flame_tpu.ops import rasterize as raster

    vtx_idepths = jnp.where(graph.vtx_mask, graph.x * graph_scale, 0.0)
    geom = mesh_filters.corner_geometry(Kinv, graph.pos, vtx_idepths, tris)
    normals = mesh_filters.vertex_normals(Kinv, graph.pos, vtx_idepths,
                                          tris, tri_mask, geom)
    tri_validity = mesh_filters.apply_filters(
        params.tri_filter, Kinv, width, graph.pos, vtx_idepths, tris,
        tri_mask, geom)
    idepthmap = raster.rasterize(graph.pos, tris, vtx_idepths, tri_mask,
                                 height, width)
    return vtx_idepths, normals, tri_validity, idepthmap


@jax.jit
def reanchor_features(feats: FeatureState, K, Kinv, stack: FrameStack,
                      kill_pf_mask, target_slot, border_lo, border_hi_x,
                      border_hi_y):
    """Move features anchored in pruned poseframes onto a surviving one
    (reference prunePoseFrames, flame.cc:603-700): predict through
    old->target geometry, propagate variance by (mu'/mu)^4, invalidate on
    failed or out-of-bounds moves."""
    needs_move = feats.valid & kill_pf_mask[feats.pf_slot]

    q_t = stack.q[target_slot]
    t_t = stack.t[target_slot]
    qa = stack.q[feats.pf_slot]
    ta = stack.t[feats.pf_slot]
    q_rel, t_rel = se3.mul(se3.inverse((q_t, t_t)), (qa, ta))
    geos = jax.vmap(epipolar.load, in_axes=(None, None, 0, 0))(
        K, Kinv, q_rel, t_rel)
    ok, u_pf, id_pf, _ = jax.vmap(
        idfilter.predict, in_axes=(0, None, 0, 0, 0))(
            geos, 1.0, feats.xy, feats.idepth_mu, feats.idepth_var)

    in_bounds = ((u_pf[:, 0] >= border_lo) & (u_pf[:, 0] < border_hi_x)
                 & (u_pf[:, 1] >= border_lo) & (u_pf[:, 1] < border_hi_y))
    move_ok = needs_move & ok & in_bounds

    ratio = jnp.where(jnp.abs(feats.idepth_mu) > 0,
                      id_pf / jnp.where(jnp.abs(feats.idepth_mu) > 0,
                                        feats.idepth_mu, 1.0), 1.0)
    vf4 = jnp.where(id_pf < 1e-6, 1.0, ratio ** 4)

    return feats._replace(
        xy=jnp.where(needs_move[:, None], u_pf, feats.xy),
        pf_slot=jnp.where(needs_move, jnp.asarray(target_slot, jnp.int32),
                          feats.pf_slot),
        idepth_mu=jnp.where(needs_move, id_pf, feats.idepth_mu),
        idepth_var=jnp.where(needs_move, feats.idepth_var * vf4,
                             feats.idepth_var),
        valid=jnp.where(needs_move, move_ok, feats.valid))
