"""Windowed BA bookkeeping and Flame integration.

Collects per-poseframe feature observations from the tracking step
(pipeline.TrackObs), maintains a bounded observation store keyed by
globally-unique feature ids and frame ids (feature SLOTS are recycled;
keying on slots would fuse observations of different physical points into
one landmark and blow up the solve), assembles fixed-shape BAProblem
windows, and applies refined poses/idepths back into the pipeline through
the same contract the reference exposes to an external estimator
(updatePoseFramePoses + feature idepth rewrite; flame.h:155-174).

Deployment posture (r4): the BA layer is FULLY ASYNCHRONOUS and issues
no blocking device reads. Observations + the per-feature/pose snapshot
ride the pipeline's existing packed transfer (pipeline.pack_ba_outputs —
ONE widened device->host fetch instead of ~10 blocking np.asarray
calls per poseframe). A solve uploads its whole problem as ONE coalesced
i32 buffer, runs as one fused jit
(decode + optional 2-D rematch + structure-tensor weights + Schur GN),
and its flat result is fetched on a background thread; poses and
refined idepths apply 1-2 dispatches later via one fused pose scatter
and one identity-guarded idepth scatter. Identity guards (the slot must
still hold the same feat_id AND anchor poseframe slot) make the apply
lag safe against slot recycling and mid-flight re-anchoring.
"""

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from flame_tpu.ba import residuals as resid
from flame_tpu.ba import schur
from flame_tpu.params import BAParams


def split_packed(params, arr: np.ndarray):
    """Host-side decode of the widened packed transfer
    (pipeline.pack_ba_outputs layout). Returns (packed_u16 (N, 3),
    snap dict or None). A plain u16 array (BA off) passes through."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        return arr, None
    N = params.feature_capacity
    P = params.poseframe_capacity
    fixed = 3 * N // 2 + 3 * N + 8 * P
    B = (arr.size - fixed) // N
    off = 0

    def take(n):
        nonlocal off
        s = arr[off: off + n]
        off += n
        return s

    pk = take(3 * N // 2).view(np.uint16).reshape(N, 3)
    uo = take(B * N).view(np.uint16).reshape(B, N, 2)
    xy = take(N).view(np.uint16).reshape(N, 2)
    mu = take(N).view(np.float32)
    id_slot = take(N)
    stack_fid = take(P)
    stack_q = take(4 * P).view(np.float32).reshape(P, 4)
    stack_t = take(3 * P).view(np.float32).reshape(P, 3)
    snap = dict(uo=uo, xy=xy, mu=mu,
                feat_id=id_slot & 0xFFFFFF,
                pf_slot=(id_slot >> 24) & 0x7F,
                stack_fid=stack_fid, stack_q=stack_q, stack_t=stack_t)
    return pk, snap


class ObservationStore:
    """Bounded columnar ring buffer of observations
    (anchor_id, obs_frame_id, feat_id, u_ref, u_obs). All operations are
    vectorized numpy — this sits on the poseframe path, so no O(rows)
    Python loops."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._aid = np.zeros(capacity, np.int64)
        self._oid = np.zeros(capacity, np.int64)
        self._fid = np.zeros(capacity, np.int64)
        self._uref = np.zeros((capacity, 2), np.float32)
        self._uobs = np.zeros((capacity, 2), np.float32)
        self._n = 0  # live rows
        self._head = 0  # ring write pointer (next slot)

    def add_frame(self, anchor_ids, obs_frame_id: int, feat_ids,
                  u_ref, u_obs) -> None:
        m = len(feat_ids)
        if m == 0:
            return
        if m > self.capacity:  # keep the newest rows of an oversized batch
            anchor_ids = anchor_ids[-self.capacity:]
            feat_ids = feat_ids[-self.capacity:]
            u_ref = u_ref[-self.capacity:]
            u_obs = u_obs[-self.capacity:]
            m = self.capacity
        idx = (self._head + np.arange(m)) % self.capacity
        self._aid[idx] = np.asarray(anchor_ids, np.int64)
        self._oid[idx] = int(obs_frame_id)
        self._fid[idx] = np.asarray(feat_ids, np.int64)
        self._uref[idx] = np.asarray(u_ref, np.float32)
        self._uobs[idx] = np.asarray(u_obs, np.float32)
        self._head = int((self._head + m) % self.capacity)
        self._n = min(self._n + m, self.capacity)

    def _ordered(self):
        """Logical-order (oldest-first) views of the live rows."""
        idx = (self._head - self._n + np.arange(self._n)) % self.capacity
        return (self._aid[idx], self._oid[idx], self._fid[idx],
                self._uref[idx], self._uobs[idx])

    def drop_frames(self, dead_ids) -> None:
        dead = np.fromiter((int(i) for i in dead_ids), np.int64)
        if dead.size == 0 or self._n == 0:
            return
        aid, oid, fid, ur, uo = self._ordered()
        keep = ~(np.isin(aid, dead) | np.isin(oid, dead))
        m = int(keep.sum())
        self._aid[:m] = aid[keep]
        self._oid[:m] = oid[keep]
        self._fid[:m] = fid[keep]
        self._uref[:m] = ur[keep]
        self._uobs[:m] = uo[keep]
        self._n = m
        self._head = m % self.capacity

    def __len__(self):
        return self._n

    def build_window(self, frame_ids: List[int],
                     pose_by_id: Dict[int, Tuple[np.ndarray, np.ndarray]],
                     lm_init: Dict[Tuple[int, int], float],
                     max_landmarks: int, max_obs: int,
                     prior_by_id: Dict[int, Tuple[np.ndarray,
                                                  np.ndarray]] = None):
        """Assemble a BAProblem over the given keyframe window.

        prior_by_id: optional fid -> (q, t) pose-prior anchors (the
        INPUT odometry poses); missing fids fall back to pose_by_id.
        None leaves the problem's prior fields unset (gn_solve then
        anchors to the current poses, the pre-r4 behavior).

        lm_init maps landmark key (feat_id, anchor_id) -> current inverse
        depth; keys absent from lm_init are skipped (the feature died or
        re-anchored). Landmarks index in first-appearance (oldest-first)
        order; rows beyond max_obs and landmarks beyond max_landmarks are
        dropped oldest-preserving, matching the original row-loop.
        Returns (problem, pose_order, landmark_keys, n_obs) or None.
        The problem fields are NUMPY arrays (the caller either packs them
        into the one-buffer solve upload or converts for the sharded
        path) — no device arrays are created here.
        """
        aid, oid, fid, ur_all, uo_all = self._ordered()
        if aid.size == 0:
            return None

        fids_arr = np.asarray(frame_ids, np.int64)
        sort = np.argsort(fids_arr)
        sf = fids_arr[sort]

        def to_window_idx(ids):
            p = np.clip(np.searchsorted(sf, ids), 0, sf.size - 1)
            ok = sf[p] == ids
            return sort[p].astype(np.int32), ok

        a_idx, a_ok = to_window_idx(aid)
        o_idx, o_ok = to_window_idx(oid)
        keep = a_ok & o_ok & (aid != oid)

        # Landmark key = (feat_id, anchor_id) packed into one int64.
        key = (fid << 32) | (aid & 0xFFFFFFFF)
        if lm_init:
            lk = np.fromiter(((int(f) << 32) | (int(a) & 0xFFFFFFFF)
                              for (f, a) in lm_init.keys()),
                             np.int64, count=len(lm_init))
            lv = np.fromiter(lm_init.values(), np.float64,
                             count=len(lm_init))
            lko = np.argsort(lk)
            lks = lk[lko]
            p = np.clip(np.searchsorted(lks, key), 0, lks.size - 1)
            keep &= lks[p] == key
        else:
            return None

        kk = key[keep]
        if kk.size < 12:
            return None
        uniq, first_idx, inv = np.unique(kk, return_index=True,
                                         return_inverse=True)
        # Landmark index = rank by first appearance (oldest-first).
        appear = np.argsort(first_idx)
        rank = np.empty(uniq.size, np.int64)
        rank[appear] = np.arange(uniq.size)
        lm_rows = rank[inv]

        sel = lm_rows < max_landmarks
        a = a_idx[keep][sel]
        o = o_idx[keep][sel]
        l = lm_rows[sel].astype(np.int32)
        ur = ur_all[keep][sel]
        uo = uo_all[keep][sel]
        if a.shape[0] > max_obs:
            a, o, l = a[:max_obs], o[:max_obs], l[:max_obs]
            ur, uo = ur[:max_obs], uo[:max_obs]
        L = min(uniq.size, max_landmarks)
        # Landmarks that lost all their rows to the obs cap keep their slot
        # (zero rows — inert in the solve), as in the original.
        if a.shape[0] < 12 or L < 4:
            return None

        uniq_in_order = uniq[appear[:L]]
        lm_idepth = lv[lko][np.searchsorted(lks, uniq_in_order)] \
            .astype(np.float32)

        M = a.shape[0]
        ur = ur.astype(np.float32)
        uo = uo.astype(np.float32)

        # Pad to fixed shapes for jit stability.
        Mp = max_obs
        pad = Mp - M
        obs = resid.BAObservations(
            anchor_idx=np.pad(a, (0, pad)),
            obs_idx=np.pad(o, (0, pad)),
            lm_idx=np.pad(l, (0, pad)),
            u_ref=np.pad(ur, ((0, pad), (0, 0))),
            u_obs=np.pad(uo, ((0, pad), (0, 0))),
            valid=np.arange(Mp) < M)

        Lp = max_landmarks
        lm_pad = np.zeros(Lp, np.float32)
        lm_pad[:L] = lm_idepth
        lm_valid = np.arange(Lp) < L

        q = np.stack([pose_by_id[f][0] for f in frame_ids]).astype(np.float32)
        t = np.stack([pose_by_id[f][1] for f in frame_ids]).astype(np.float32)
        pq = pt = None
        if prior_by_id:
            pq = np.stack([prior_by_id.get(f, pose_by_id[f])[0]
                           for f in frame_ids]).astype(np.float32)
            pt = np.stack([prior_by_id.get(f, pose_by_id[f])[1]
                           for f in frame_ids]).astype(np.float32)

        problem = schur.BAProblem(
            q=q, t=t, lm_idepth=lm_pad, lm_valid=lm_valid, obs=obs,
            prior_q=pq, prior_t=pt)
        keys = list(zip((uniq_in_order >> 32).tolist(),
                        (uniq_in_order & 0xFFFFFFFF).tolist()))
        return problem, list(frame_ids), keys, M


def _pack_problem(problem: schur.BAProblem, slot_w: np.ndarray) -> np.ndarray:
    """Coalesce the whole window problem into ONE i32 upload buffer:
    [q 4P | t 3P | prior_q 4P | prior_t 3P | lm L | lm_valid L |
    a_idx M | o_idx M | l_idx M | u_ref 2M | u_obs 2M | valid M |
    slot_w P] (f32 sections bitcast)."""
    obs = problem.obs
    pq = problem.prior_q if problem.prior_q is not None else problem.q
    pt = problem.prior_t if problem.prior_t is not None else problem.t
    return np.concatenate([
        np.ascontiguousarray(problem.q, np.float32).view(np.int32).ravel(),
        np.ascontiguousarray(problem.t, np.float32).view(np.int32).ravel(),
        np.ascontiguousarray(pq, np.float32).view(np.int32).ravel(),
        np.ascontiguousarray(pt, np.float32).view(np.int32).ravel(),
        np.ascontiguousarray(problem.lm_idepth,
                             np.float32).view(np.int32).ravel(),
        np.asarray(problem.lm_valid, np.int32),
        np.asarray(obs.anchor_idx, np.int32),
        np.asarray(obs.obs_idx, np.int32),
        np.asarray(obs.lm_idx, np.int32),
        np.ascontiguousarray(obs.u_ref, np.float32).view(np.int32).ravel(),
        np.ascontiguousarray(obs.u_obs, np.float32).view(np.int32).ravel(),
        np.asarray(obs.valid, np.int32),
        np.asarray(slot_w, np.int32)])


@functools.partial(jax.jit, static_argnames=("p", "pad", "n_fixed",
                                             "P", "L", "M"))
def _solve_packed(p: BAParams, K, Kinv, buf, img_pad, img_pack, pad: int,
                  n_fixed: int, P: int, L: int, M: int):
    """Decode the coalesced problem upload, optionally 2-D-rematch and
    weight, run the Schur Gauss-Newton window solve, and return ONE flat
    f32 result [q 4P | t 3P | lm L | cost] — one upload in, one staged
    fetch out."""
    off = 0

    def take(n):
        nonlocal off
        s = jax.lax.dynamic_slice_in_dim(buf, off, n)
        off += n
        return s

    f32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
    q = f32(take(4 * P)).reshape(P, 4)
    t = f32(take(3 * P)).reshape(P, 3)
    prior_q = f32(take(4 * P)).reshape(P, 4)
    prior_t = f32(take(3 * P)).reshape(P, 3)
    lm = f32(take(L))
    lm_valid = take(L) > 0
    a_idx = take(M)
    o_idx = take(M)
    l_idx = take(M)
    u_ref = f32(take(2 * M)).reshape(M, 2)
    u_obs = f32(take(2 * M)).reshape(M, 2)
    valid = take(M) > 0
    slot_w = take(P)

    obs = resid.BAObservations(anchor_idx=a_idx, obs_idx=o_idx,
                               lm_idx=l_idx, u_ref=u_ref, u_obs=u_obs,
                               valid=valid)
    problem = schur.BAProblem(q=q, t=t, lm_idepth=lm, lm_valid=lm_valid,
                              obs=obs, prior_q=prior_q, prior_t=prior_t)

    sqrtW = None
    if p.do_rematch:
        from flame_tpu.ba import rematch
        u_obs2, _ = rematch.rematch_observations(
            K, Kinv, img_pad, pad, q, t, a_idx, o_idx,
            slot_w[a_idx], slot_w[o_idx], u_ref, u_obs, l_idx, lm,
            valid, radius=p.rematch_radius, max_cost=p.rematch_max_cost,
            min_eig=p.rematch_min_eig, img_pack=img_pack)
        problem = problem._replace(obs=obs._replace(u_obs=u_obs2))
    if p.aniso_weights:
        from flame_tpu.ba import rematch
        sqrtW = rematch.observation_weights(img_pad, pad, slot_w[a_idx],
                                            u_ref, img_pack=img_pack)

    qf, tf, lmf, cost = schur.solve_window.__wrapped__(
        p, K, Kinv, problem, n_fixed=n_fixed, sqrtW=sqrtW)
    return jnp.concatenate([qf.reshape(-1), tf.reshape(-1), lmf,
                            cost.reshape(1)])


@jax.jit
def _apply_idepths(feats, trip):
    """Scatter refined idepths back into the feature state: trip (L, 4)
    i32 rows [slot, feat_id, anchor_slot, mu_bits]. Guarded by full
    identity — the slot must still hold the same feat_id AND the same
    anchor poseframe slot. A feature re-anchored between solve stage
    and apply (eviction-driven reanchor_features, or a track move)
    keeps its feat_id and validity but its idepth is re-parameterized
    into the NEW anchor frame; writing the solve's refined value (in
    the OLD anchor frame) over it would inject a wrong-scale depth.
    Re-anchoring always changes pf_slot (the reanchor target is never
    the killed slot), so the anchor-slot comparison catches every such
    case."""
    slots = trip[:, 0]
    ids = trip[:, 1]
    anchor_slots = trip[:, 2]
    mus = jax.lax.bitcast_convert_type(trip[:, 3], jnp.float32)
    N = feats.idepth_mu.shape[0]
    sl = jnp.clip(slots, 0, N - 1)
    # Compare ids MASKED to 24 bits: the packed transfer carries
    # feat_id mod 2^24 (pipeline.pack_ba_outputs id_slot word), so the
    # host-side ids are masked — comparing against the full device id
    # would silently reject every write-back once the id counter
    # crosses 2^24.
    ok = (slots >= 0) \
        & ((feats.feat_id[sl] & 0xFFFFFF) == (ids & 0xFFFFFF)) \
        & (feats.pf_slot[sl] == anchor_slots) \
        & feats.valid[sl]
    tgt = jnp.where(ok, sl, N)
    return feats._replace(
        idepth_mu=feats.idepth_mu.at[tgt].set(mus, mode="drop"))


class BundleAdjuster:
    """Drives windowed BA over a Flame instance, asynchronously: obs +
    state snapshots arrive on the pipeline's packed transfer, solves run
    as one fused dispatch with a background result fetch, and results
    apply 1-2 dispatches later under identity guards."""

    def __init__(self, params: BAParams, K, Kinv, mesh=None):
        """mesh: optional jax.sharding.Mesh — when set, the Gauss-Newton
        assembly runs observation-sharded over the mesh with psum'd
        Hessian blocks (parallel/distributed_ba.solve_window_sharded),
        the collective-reduction design SURVEY.md section 2b calls for. The
        sharded path applies synchronously (it runs under the CPU
        multi-controller test harness where fetches are free)."""
        self.params = params
        self.K = K
        self.Kinv = Kinv
        self.mesh = mesh
        self.store = ObservationStore(params.obs_capacity)
        self.last_cost: Optional[float] = None
        self.last_accepted: bool = False
        self._snap = None  # latest decoded host snapshot
        self._snap_dirty = False  # new observations since the last solve?
        self._inflight = None  # (fetch, meta) of a staged solve result
        self._new_pf_count = 0  # poseframes ingested since the last solve
        # fid -> (q, t) INPUT pose: each poseframe's pose from the first
        # snapshot that contains it — before any BA refinement touched
        # it. The window solve's pose prior anchors HERE, not to the
        # current (already-refined) values: anchoring to refined poses
        # lets the sliding window random-walk away from the odometry
        # (measured r4: 4 -> 15 mm growing drift over 60 frames on
        # EXACT input poses), while anchoring to the input bounds the
        # drift at the prior's uncertainty.
        self._input_pose_by_id: Dict[int, tuple] = {}

    # ------------------------------------------------------------------
    # Snapshot ingestion (called from Flame._consume_packed).
    # ------------------------------------------------------------------

    def ingest_snapshot(self, snap: dict, fids, pf_flags) -> None:
        """Digest one decoded packed transfer: record the poseframe
        frames' successful matches into the store and keep the snapshot
        for the next solve. fids/pf_flags: the dispatch's frames (host
        metadata stamped when the transfer was staged)."""
        from flame_tpu.core import pipeline
        uo = snap["uo"]
        B = uo.shape[0]
        scale = 1.0 / pipeline.PACK_XY_SCALE
        for b in range(min(B, len(fids))):
            if not pf_flags[b]:
                continue
            fid = int(fids[b])
            success = uo[b, :, 0] != pipeline.PACK_BA_FAIL
            slots = np.nonzero(success)[0]
            if slots.size == 0:
                continue
            anchor_ids = snap["stack_fid"][snap["pf_slot"][slots]]
            keep = anchor_ids != fid
            slots = slots[keep]
            if slots.size == 0:
                continue
            u_ref = snap["xy"][slots].astype(np.float32) * scale
            u_obs = uo[b, slots].astype(np.float32) * scale
            self.store.add_frame(anchor_ids[keep], fid,
                                 snap["feat_id"][slots], u_ref, u_obs)
            self._snap_dirty = True
            self._new_pf_count += 1  # a POSEFRAME's obs landed
        self._snap = snap
        # Record newly-seen poseframes' INPUT poses (a new pf cannot
        # have been refined yet: solves staged before it existed don't
        # carry its slot) and drop entries for evicted ones.
        live = {int(f) for f in snap["stack_fid"].tolist() if f >= 0}
        for i, f in enumerate(snap["stack_fid"].tolist()):
            if f >= 0 and int(f) not in self._input_pose_by_id:
                self._input_pose_by_id[int(f)] = (
                    snap["stack_q"][i].copy(), snap["stack_t"][i].copy())
        for f in [f for f in self._input_pose_by_id if f not in live]:
            del self._input_pose_by_id[f]

    def _snapshot_landmarks(self, feat_valid: np.ndarray):
        """(feat_id, anchor_id) -> (slot, idepth, anchor_slot) from the
        snapshot — NO device reads (r3's _current_landmarks issued
        four). anchor_slot feeds the write-back's anchor guard."""
        s = self._snap
        sel = np.nonzero(feat_valid & (s["mu"] > 1e-6))[0]
        aslots = s["pf_slot"][sel]
        anchors = s["stack_fid"][aslots]
        return {(int(f), int(a)): (int(sl), float(m), int(asl))
                for f, a, sl, m, asl in zip(s["feat_id"][sel].tolist(),
                                            anchors.tolist(), sel.tolist(),
                                            s["mu"][sel].tolist(),
                                            aslots.tolist())}

    # ------------------------------------------------------------------
    # Pipeline advance (called once per Flame.update()).
    # ------------------------------------------------------------------

    def step(self, fl, force: bool = False) -> None:
        """Advance the async solve pipeline: apply a finished solve
        result if one landed, else stage a new solve when fresh
        observations are waiting. force=True joins blocking (quiesce).
        Under solver.deterministic every join is forced — the
        opportunistic ready() checks depend on thread wall-clock and
        would break bit-reproducible resume."""
        force = force or bool(fl.params.solver.deterministic)
        if self._inflight is not None:
            fetch, meta = self._inflight
            if force or fetch.ready():
                self._inflight = None
                self._apply(fl, fetch.get(), meta)
            else:
                return  # one solve in flight at a time
        if self._snap is not None and self._snap_dirty \
                and len(fl._pf_slot_by_id) >= 3 \
                and self._new_pf_count >= self.params.solve_min_new_pfs:
            # _new_pf_count counts INGESTED poseframes (not frame ids —
            # a frontend's sparse frame numbering must not inflate the
            # cadence), and resets only when a solve actually stages.
            self._stage_solve(fl)

    def quiesce(self, fl) -> None:
        """Join and apply any in-flight solve (checkpoint/save path).
        step() may STAGE a fresh solve right after applying the old one
        (pending observations), so drain that one too — a checkpoint
        must leave nothing in flight (the restored instance starts with
        none; an undrained solve would make the continued run diverge
        from the resumed one)."""
        self.step(fl, force=True)
        if self._inflight is not None:
            fetch, meta = self._inflight
            self._inflight = None
            self._apply(fl, fetch.get(), meta)

    def _stage_solve(self, fl, n_fixed: int = 2) -> None:
        p = self.params
        live = sorted(fl._pf_slot_by_id.keys())
        window_ids = live[-p.window_size:]
        if len(window_ids) < max(n_fixed + 1, 3):
            return

        # Poses from the snapshot (includes all previously APPLIED BA
        # refinements — set_poses writes the device stack the snapshot
        # is taken from). Window members must exist in the snapshot (a
        # poseframe added after the snapshot was taken waits one round).
        s = self._snap
        snap_slot_by_id = {int(f): i for i, f in
                          enumerate(s["stack_fid"].tolist()) if f >= 0}
        window_ids = [f for f in window_ids if f in snap_slot_by_id]
        if len(window_ids) < max(n_fixed + 1, 3):
            return
        pose_by_id = {f: (s["stack_q"][snap_slot_by_id[f]],
                          s["stack_t"][snap_slot_by_id[f]])
                      for f in window_ids}
        lm_map = self._snapshot_landmarks(fl._feat_valid_np)
        lm_init = {k: v[1] for k, v in lm_map.items()}

        built = self.store.build_window(window_ids, pose_by_id, lm_init,
                                        max_landmarks=p.max_landmarks,
                                        max_obs=p.max_obs,
                                        prior_by_id=self._input_pose_by_id)
        if built is None:
            return
        # Charge the cadence only for a solve that actually stages —
        # early returns above leave the pending observations eligible
        # for the next attempt instead of silently waiting a full extra
        # cadence period.
        self._snap_dirty = False
        self._new_pf_count = 0
        problem, order, keys, n_obs = built
        # Landmark -> CURRENT slot map for the write-back (validated
        # again on device at apply time: feat_id AND anchor slot — a
        # feature re-anchored between stage and apply keeps its id but
        # its refined idepth would be expressed in the WRONG anchor
        # frame, so the anchor slot must still match too).
        lm_slots = np.array([lm_map[k][0] if k in lm_map else -1
                             for k in keys], np.int32)
        lm_ids = np.array([k[0] for k in keys], np.int32)
        lm_anchor_slots = np.array(
            [lm_map[k][2] if k in lm_map else -1 for k in keys], np.int32)
        slot_w = np.array([fl._pf_slot_by_id[f] for f in order], np.int32)
        P = len(order)
        L = p.max_landmarks
        M = p.max_obs
        meta = dict(order=order, keys=keys, lm_slots=lm_slots,
                    lm_ids=lm_ids, lm_anchor_slots=lm_anchor_slots,
                    P=P, L=L, n_obs=n_obs,
                    # Staged input poses, for the write-back innovation
                    # gate at apply time (params.writeback_min_dt).
                    q_in=np.array(problem.q, np.float32),
                    t_in=np.array(problem.t, np.float32))

        if self.mesh is not None:
            # Observation-sharded psum'd assembly over the mesh — ALWAYS
            # taken when a mesh is configured (rows are
            # padded to device divisibility and sqrtW shards with them;
            # no silent single-device fallback remains). Counted so a
            # deployment can see which path its solves take. Applies
            # synchronously (multi-controller CPU harness).
            from flame_tpu.parallel import distributed_ba
            from flame_tpu.ba import rematch
            fl.stats.add("ba_sharded_solves", 1)
            prob_dev = jax.tree.map(jnp.asarray, problem)
            obs = prob_dev.obs
            sqrtW = None
            sw = jnp.asarray(slot_w)
            if p.do_rematch:
                u_obs2, _ = rematch.rematch_observations(
                    self.K, self.Kinv, fl._stack.img_pad, fl.params.pad,
                    prob_dev.q, prob_dev.t, obs.anchor_idx, obs.obs_idx,
                    sw[obs.anchor_idx], sw[obs.obs_idx],
                    obs.u_ref, obs.u_obs, obs.lm_idx, prob_dev.lm_idepth,
                    obs.valid, radius=p.rematch_radius,
                    max_cost=p.rematch_max_cost, min_eig=p.rematch_min_eig,
                    img_pack=fl._stack.img_pack)
                prob_dev = prob_dev._replace(
                    obs=obs._replace(u_obs=u_obs2))
            if p.aniso_weights:
                sqrtW = rematch.observation_weights(
                    fl._stack.img_pad, fl.params.pad, sw[obs.anchor_idx],
                    obs.u_ref, img_pack=fl._stack.img_pack)
            q, t, lm, cost = distributed_ba.solve_window_sharded(
                p, self.K, self.Kinv, prob_dev, self.mesh,
                n_fixed=n_fixed, sqrtW=sqrtW)
            flat = np.concatenate([np.asarray(q).reshape(-1),
                                   np.asarray(t).reshape(-1),
                                   np.asarray(lm).reshape(-1),
                                   np.asarray(cost).reshape(1)])
            self._apply(fl, flat, meta)
            return

        from flame_tpu.core.flame import _AsyncFetch
        fl.stats.add("ba_single_solves", 1)
        buf = jnp.asarray(_pack_problem(problem, slot_w))  # ONE upload
        res_dev = _solve_packed(p, self.K, self.Kinv, buf,
                                fl._stack.img_pad, fl._stack.img_pack,
                                fl.params.pad, n_fixed, P, L, M)
        self._inflight = (_AsyncFetch(res_dev), meta)

    def _apply(self, fl, flat: np.ndarray, meta: dict) -> None:
        """Acceptance-check a finished solve and write poses + refined
        idepths back: one fused pose scatter + one identity-guarded
        idepth scatter (no blocking reads)."""
        from flame_tpu.core import frame as frame_mod
        p = self.params
        flat = np.asarray(flat)
        P, L = meta["P"], meta["L"]
        q = flat[: 4 * P].reshape(P, 4)
        t = flat[4 * P: 7 * P].reshape(P, 3)
        lm = flat[7 * P: 7 * P + L]
        cost = float(flat[7 * P + L])
        self.last_cost = cost
        mean_cost = cost / max(meta["n_obs"], 1)
        self.last_accepted = bool(np.isfinite(mean_cost)
                                  and mean_cost < p.max_mean_cost)
        if not self.last_accepted:
            return

        # Poses: only frames still resident apply (prune/evict between
        # stage and apply invalidates a row).
        rows = [(fl._pf_slot_by_id[f], i)
                for i, f in enumerate(meta["order"])
                if f in fl._pf_slot_by_id]
        if rows:
            slots = np.array([r[0] for r in rows], np.int32)
            sel = np.array([r[1] for r in rows], np.int32)
            fl._stack = frame_mod.set_poses(
                fl._stack, jnp.asarray(slots),
                jnp.asarray(q[sel].astype(np.float32)),
                jnp.asarray(t[sel].astype(np.float32)))

        # Write-back innovation gate: when the solve barely moved the
        # window poses, refined depths are just rematch-noise
        # re-triangulations of already-converged filter depths — skip
        # the depth write-back (poses above always apply; the skip is
        # counted). See params.writeback_min_dt.
        if p.writeback_min_dt > 0 or p.writeback_min_drot > 0:
            from flame_tpu.utils import evaluation
            pe = evaluation.pose_errors(q, t, meta["q_in"], meta["t_in"])
            # A zero threshold disables that AXIS (it always passes the
            # skip test), not the whole gate — otherwise setting only
            # one threshold would make the skip condition unsatisfiable
            # and silently turn the gate off.
            t_small = (p.writeback_min_dt <= 0
                       or pe["t_max"] < p.writeback_min_dt)
            r_small = (p.writeback_min_drot <= 0
                       or np.radians(pe["r_max_deg"]) < p.writeback_min_drot)
            if t_small and r_small:
                fl.stats.add("ba_writeback_skips", 1)
                return

        # Refined idepths: ONE (L, 4) upload + guarded scatter. Rows are
        # padded to the FIXED max_landmarks shape (slot -1 = inert) so
        # _apply_idepths compiles once, not per landmark count.
        Lk = meta["lm_slots"].shape[0]
        slots_p = np.full(L, -1, np.int32)
        ids_p = np.full(L, -1, np.int32)
        aslots_p = np.full(L, -1, np.int32)
        slots_p[:Lk] = meta["lm_slots"]
        ids_p[:Lk] = meta["lm_ids"]
        aslots_p[:Lk] = meta["lm_anchor_slots"]
        trip = np.stack([slots_p, ids_p, aslots_p,
                         lm.astype(np.float32).view(np.int32)],
                        axis=1).astype(np.int32)
        fl._feats = _apply_idepths(fl._feats, jnp.asarray(trip))
