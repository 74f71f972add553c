"""Flame: the whole-pipeline orchestrator.

JAX re-design of the reference's Flame class
(/root/reference/src/flame/flame.h:123-309, flame.cc:44-552): per-frame
dense inverse-depth mesh estimation from a posed monocular stream.

Where the reference runs three threads (update / detection / free-running
graph smoothing) over mutex-guarded mutable state, this orchestrator is a
host loop around four jitted device steps with fixed-capacity SoA state:

  1. track_project_sync — feature tracking, measurement, fusion, projection,
     graph-membership gating (one fused jit over all feature slots).
  2. host Delaunay over the member features (the only host compute) +
     edge-array construction with dual-variable carry-over.
  3. graph_sync + K NLTGV2 smoothing iterations (deterministic iteration
     budget replaces the free-running graph thread, flame.cc:98-112).
  4. mesh extraction: vertex idepths/normals, triangle filters, dense
     rasterization.

Detection runs synchronously on poseframes but its results are staged and
drained at the next update, reproducing the reference's detection-thread
timing (flame.cc:708-773 vs :250-260).
"""

import collections
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from flame_tpu.geometry import se3, epipolar
from flame_tpu.mesh import delaunay, filters
from flame_tpu.optimize import nltgv2, topology
from flame_tpu.ops import rasterize
from flame_tpu.params import Params
from flame_tpu.core import detection, frame as frame_mod, keyframe, pipeline
from flame_tpu.utils.stats import StatsTracker

# Jitted two-view geometry construction (one dispatch instead of an eager
# SE(3)+matmul chain of dozens).
_load_rel = jax.jit(epipolar.load_relative)

# update()'s first positional is the sensor timestamp and shadows the
# module name inside that scope.
_perf_counter = time.perf_counter


class _AsyncFetch:
    """Staged device->host transfer on a background thread.

    A plain np.asarray waits for everything enqueued before it, so a
    blocking fetch on the main thread costs a drain of the device queue.
    A daemon thread issuing np.asarray overlaps that wait with host
    Delaunay and later dispatches; with solver.topology_lag=2 the result
    is consumed a full frame after the transfer completes.
    """

    __slots__ = ("_dev", "_np", "_thread", "_post", "_extra", "_exc",
                 "t_start", "t_done")

    def __init__(self, dev_arr, post=None):
        """post: optional host-side callable run on the fetched array INSIDE
        the worker thread (numpy/ctypes only — no jax dispatches, which must
        stay on the main thread to keep the device queue ordered). Its
        result is returned by get() alongside the array. Used to overlap
        Delaunay triangulation with device compute, the way the reference
        overlaps its detection/graph threads with update() (flame.cc:98-116).
        """
        self._dev = dev_arr
        self._np = None
        self._post = post
        self._extra = None
        self._exc = None
        self.t_start = time.perf_counter()
        self.t_done = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            self._np = np.asarray(self._dev)
            if self._post is not None:
                self._extra = self._post(self._np)
        except BaseException as e:  # re-raised on the main thread
            self._exc = e
        self.t_done = time.perf_counter()

    def ready(self) -> bool:
        return not self._thread.is_alive()

    def get(self) -> np.ndarray:
        self._thread.join()
        if self._exc is not None:
            # Surface the real device/transfer error instead of handing
            # the caller a None it will trip over later.
            raise self._exc
        return self._np

    def get_extra(self):
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._extra


class _AsyncWork:
    """Run fn() in a worker thread (second pipeline stage: host Delaunay +
    RCM overlap with device compute, like the reference's triangulation
    inside syncGraph overlapping the free-running graph thread)."""

    __slots__ = ("_fn", "_result", "_thread", "_exc")

    def __init__(self, fn):
        self._fn = fn
        self._result = None
        self._exc = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            self._result = self._fn()
        except BaseException as e:  # re-raised on the main thread
            self._exc = e

    def ready(self) -> bool:
        return not self._thread.is_alive()

    def get(self):
        self._thread.join()
        if self._exc is not None:
            # e.g. a degenerate (collinear) member set raising inside
            # Delaunay: fail loudly instead of silently freezing the
            # topology behind a None result.
            raise self._exc
        return self._result


class Flame:
    """Dense inverse-depth mesh estimation (reference flame.h:96)."""

    # Device mesh for the halo smoother; set by ShardedFlame before
    # super().__init__ runs. None = one device.
    _sharding_mesh = None

    def __init__(self, width: int, height: int, K, Kinv, params: Params = None):
        self.params = params or Params()
        p = self.params
        self.width = width
        self.height = height
        self.K = jnp.asarray(K, jnp.float32)
        self.Kinv = jnp.asarray(Kinv, jnp.float32)

        # The packed track transfer carries pixel coordinates in
        # PACK_XY_SCALE fixed point (u16): images at or beyond
        # 65536/PACK_XY_SCALE px would silently saturate the packed
        # snapshot and corrupt the Delaunay input — fail loudly instead
        # (core/pipeline.pack_track_outputs).
        lim = int(65536 / pipeline.PACK_XY_SCALE)
        if width >= lim or height >= lim:
            raise ValueError(
                f"image {width}x{height} exceeds the packed-coordinate "
                f"range (< {lim} px per side at PACK_XY_SCALE="
                f"{pipeline.PACK_XY_SCALE:g}); lower PACK_XY_SCALE for "
                f"larger images")
        if p.do_ba and p.feature_capacity % 2:
            raise ValueError("do_ba needs an even feature_capacity "
                             "(u16-pair bitcasts in pack_ba_outputs)")
        if p.do_ba and p.poseframe_capacity > 128:
            raise ValueError("do_ba packs pf_slot into bits 24..30 of "
                             "the id_slot word; poseframe_capacity must "
                             "be <= 128 (pack_ba_outputs)")

        self.stats = StatsTracker()
        self._smoother_mode = pipeline.resolve_smoother(
            p, self._sharding_mesh)
        # The halo smoother rides the perm + RCM-edge-rank segments of the
        # topology upload instead of the [V, D] incidence tables.
        self._rank_layout = self._smoother_mode == "halo"
        self.inited = False
        self.num_imgs = 0
        self.num_data_updates = 0
        self.num_regularizer_updates = 0
        # Device-resident graph scale (renormalized when rescale_data).
        self._graph_scale_dev = jnp.float32(1.0)

        N, E, T = p.feature_capacity, p.edge_capacity, p.triangle_capacity
        self._stack = frame_mod.empty_stack(
            p.poseframe_capacity, height, width, p.pad,
            pack_dtype=(jnp.bfloat16 if p.fparams.sparams.table_bf16
                        else jnp.float32))
        self._feats = pipeline.empty_features(N)
        self._curr = pipeline.CurrFeatures(
            xy=jnp.zeros((N, 2), jnp.float32), idepth=jnp.zeros(N),
            var=jnp.zeros(N), valid=jnp.zeros(N, bool))
        self._graph = nltgv2.empty(N, E, p.solver.max_vertex_degree)
        self._tris = jnp.zeros((T, 3), jnp.int32)
        self._tri_mask = jnp.zeros((T,), bool)
        self._tris_staged = None  # raw (tris_dev, n_tris) awaiting _ensure
        self._tri_validity = jnp.zeros((T,), bool)
        self._vtx_idepths = jnp.zeros((N,), jnp.float32)
        self._vtx_normals = jnp.zeros((N, 3), jnp.float32)
        self._idepthmap = jnp.full((height, width), jnp.nan, jnp.float32)
        self._edges_np = np.zeros((E, 2), np.int64)
        self._n_edges = 0
        self._n_tris = 0
        # Coalesced-upload state: a freshly triangulated topology buffer
        # (host u16) waits here to ride the NEXT frame's image upload as
        # one combined transfer (solver.coalesce_uploads).
        self._pending_topo = None
        self._staged_offset = 0  # u8 byte offset of topo words in buf_dev
        self._staged_fresh = False  # topo applied for the first time?
        # u16 layout: [n_tris, n_edges | tris | edge_src | ranks | carry
        # | perm (halo)] — shared with _host_triangulate, _fill_carry
        # and pipeline.post_delaunay_step; change all together.
        self._topo_words = 2 + 3 * T + 3 * E + \
            (N if self._rank_layout else 0)

        # Host bookkeeping. Mirrors avoid per-frame blocking device reads
        # (each one drains the device queue).
        self._feat_valid_np = np.zeros(N, bool)  # host mirror of feats.valid
        self._n_valid = 0
        self._feat_id_counter = 0  # globally-unique feature id allocator
        self._pf_free = list(range(p.poseframe_capacity))
        self._coverage = None  # device scalar, fetched lazily
        self._warned_capacity = False  # one-shot capacity-drop warning
        self._pf_slot_by_id: Dict[int, int] = {}
        self._curr_pf_slot: Optional[int] = None
        self._curr_pf_id: Optional[int] = None
        self._curr_pf_pose_np = None  # host copy for auto-poseframe scoring
        self._fnew = None
        self._fprev = None
        # (buf_dev, n_tris, tris_np, edges_np, n_edges) staged for async
        # topology.
        self._staged_tris = None
        self._tri_pending = None  # in-flight async Delaunay (_AsyncWork)
        self._staged_frame = None  # num_imgs of the staged topology's snapshot
        # In-flight packed track transfers (oldest first, stamped with
        # num_imgs). The fetch loop free-runs: transfers are consumed when
        # ready, staged only while fewer than topology_lag are in flight —
        # update() never blocks on a device->host round trip except the
        # bounded-shed backstop (_drain_packed_queue).
        self._packed_queue = collections.deque()
        # Shed transfers whose device->host copy is still in flight (a
        # staged np.asarray cannot be cancelled): they count against the
        # in-flight depth cap until they land, then their bytes are
        # discarded (latency samples are still harvested — the landing
        # proves when that dispatch's outputs became host-visible).
        self._zombie_fetches = []
        self._sheds_since_consume = 0
        # update()-entry perf stamps by frame id; popped when the frame's
        # dispatch stages a packed fetch. When that fetch LANDS, t_done -
        # t_entry is the frame's update->map-host-visible latency
        # (the packed transfer is enqueued after the dispatch's compute,
        # so its landing proves the dense map exists and is fetchable).
        self._entry_stamp: Dict[int, float] = {}
        self._latency_samples = []
        # Batch-dispatch state (solver.frame_batch >= 2): the buffered
        # first frames of a batch, the host copy of the last APPLIED
        # topology words (re-uploaded with every batch), the pose of the
        # frame whose pixel coordinates the graph currently holds, and a
        # dispatch counter (fetch_stride cadence under batching).
        self._batch_pending = []
        self._last_topo_host = None
        self._topo_dev = None  # cached device copy (resident batching)
        self._last_sync_pose = None
        self._dispatches = 0
        self._tris_np = np.zeros((0, 3), np.int64)
        self._n_members = 0
        self._last_stats_dev = jnp.zeros(pipeline.N_STATS, jnp.int32)
        self._last_track_obs = None

        # Detection grid dims.
        self._cy = -(-height // p.detection.win_size)
        self._cx = -(-width // p.detection.win_size)
        self._add_cap = self._cy * self._cx

        # Optional internal windowed BA (beyond the reference, which
        # assumes an external estimator). ba_mesh (set by subclasses /
        # callers running under a device mesh) routes the Gauss-Newton
        # assembly through the observation-sharded psum path.
        self._ba = None
        if p.do_ba:
            from flame_tpu.ba.window import BundleAdjuster
            self._ba = BundleAdjuster(p.ba, self.K, self.Kinv,
                                      mesh=getattr(self, "_ba_mesh", None))

    # ------------------------------------------------------------------
    # Main entry point (reference flame.cc:127-552).
    # ------------------------------------------------------------------

    def update(self, time: float, frame_id: int, pose, img,
               is_poseframe: Optional[bool] = None) -> bool:
        """Process one posed image. pose = (q wxyz, t) camera-to-world.

        is_poseframe=None defers the decision to the automatic selector
        when params.auto_poseframe is set (else it means False, matching
        the reference's caller-decides contract, flame.h:145-147)."""
        p = self.params
        self.stats.tick("update")
        self._entry_stamp[frame_id] = _perf_counter()
        if len(self._entry_stamp) > 4096:
            # Frames whose dispatch staged no fetch never pop their stamp;
            # bound the dict (oldest first — dicts keep insertion order).
            for k in list(self._entry_stamp)[:2048]:
                del self._entry_stamp[k]

        q, t = pose
        # Host copies of the pose are needed only by the automatic
        # poseframe selector. When the caller passes DEVICE arrays,
        # np.asarray here is a blocking device->host read that also
        # drains the whole device queue — so take it only on the paths
        # that need it.
        q_np = t_np = None
        if is_poseframe is None and p.auto_poseframe:
            q_np = np.asarray(q, np.float64)
            t_np = np.asarray(t, np.float64)
            is_poseframe = self._want_poseframe(q_np, t_np)
        elif is_poseframe is None:
            is_poseframe = False
        q = jnp.asarray(q, jnp.float32)
        t = jnp.asarray(t, jnp.float32)

        if self._batch_ok(img):
            # Buffer until frame_batch frames are pending, then dispatch
            # them as one fused device step (+frame_batch-1 frames of
            # output latency, 1/frame_batch the dispatches/transfers).
            if is_poseframe and p.auto_poseframe:
                # Later buffered frames must compare against THIS pose
                # (slot bookkeeping stays deferred to dispatch): without
                # it every frame of the batch can trip the disparity
                # threshold against the stale poseframe and produce
                # back-to-back poseframes sequential processing would
                # not declare.
                self._curr_pf_pose_np = (
                    q_np if q_np is not None else np.asarray(q, np.float64),
                    t_np if t_np is not None else np.asarray(t, np.float64))
            self._batch_pending.append((time, frame_id, q, t, img,
                                        bool(is_poseframe), q_np, t_np))
            if len(self._batch_pending) < int(self.params.solver.frame_batch):
                self.stats.tock("update")
                return True
            frames = self._batch_pending
            self._batch_pending = []
            return self._update_batch(frames)
        self._flush_batch()
        return self._update_single(time, frame_id, q, t, img, is_poseframe,
                                   q_np, t_np)

    @staticmethod
    def _img_mode(img):
        """'host' for a numpy uint8 image (coalesced upload), 'resident'
        for a device uint8 array (DMA/PCIe-style ingestion: the image is
        already on device; only topology words are uploaded), else
        None (ineligible for batching)."""
        if isinstance(img, np.ndarray) and img.dtype == np.uint8:
            return "host"
        if isinstance(img, jax.Array) and img.dtype == jnp.uint8:
            return "resident"
        return None

    def _batch_ok(self, img) -> bool:
        """Steady-state eligibility for the N-frame fused dispatch.
        coalesce_uploads is required only for HOST images (the combined
        image+topology transfer); device-resident ingestion performs no
        host coalescing, so it batches regardless."""
        p = self.params
        return (p.solver.frame_batch >= 2 and p.solver.async_topology
                and (p.solver.coalesce_uploads
                     or self._img_mode(img) == "resident")
                and self.inited and self._curr_pf_slot is not None
                and self._fnew is not None
                and self._last_topo_host is not None
                and self._img_mode(img) is not None
                and (not self._batch_pending
                     or self._img_mode(self._batch_pending[0][4])
                     == self._img_mode(img))
                and (self._n_valid > 0 or bool(self._packed_queue)))

    def _flush_batch(self):
        """Drain buffered batch frames through the single-frame path
        (called when batching disengages or an external API needs every
        update reflected in state)."""
        if not self._batch_pending:
            return
        pending = self._batch_pending
        self._batch_pending = []
        for (_, fid, q, t, img, is_pf, qn, tn) in pending:
            self.stats.tick("update")  # scope the flushed frame's timing
            self._update_single(None, fid, q, t, img, is_pf, qn, tn)
        self.stats.tick("update")  # restore the caller's frame timer

    def _update_single(self, time, frame_id, q, t, img, is_poseframe,
                       q_np=None, t_np=None) -> bool:
        p = self.params
        img_arg = self._prepare_upload(img)

        # Steady-state fast path: frame creation (+ poseframe insertion)
        # fuses into the track dispatch — one device dispatch per frame
        # where the cold path issues three.
        fast = (self.inited and self._curr_pf_slot is not None
                and self._fnew is not None  # e.g. right after restore
                and (self._n_valid > 0 or bool(self._packed_queue)))

        if is_poseframe:
            self.stats.tick("pf_insert")
            slot = self._alloc_pf_slot(frame_id)
            self._pf_slot_by_id[frame_id] = slot
            self._curr_pf_slot = slot
            self._curr_pf_id = frame_id
            if p.auto_poseframe:
                if q_np is None:
                    q_np = np.asarray(q, np.float64)
                    t_np = np.asarray(t, np.float64)
                self._curr_pf_pose_np = (q_np, t_np)
            self.stats.tock("pf_insert")

        self.num_imgs += 1

        if fast:
            do_detect = bool(is_poseframe and (p.detection.continuous
                                               or self.num_data_updates < 1))
            self.stats.tick("update_idepths")
            prev_f = self._fnew
            (fnew, stack2, feats, curr, member, stat_vec, track_obs,
             packed_dev) = pipeline.frame_track_step(
                p, self.K, self.Kinv, self._stack, self._feats, img_arg,
                jnp.int32(frame_id), q, t, self._curr_pf_slot,
                prev_f.q, prev_f.t, jnp.int32(self._feat_id_counter),
                self._idepthmap, do_detect, bool(is_poseframe),
                self.height, self.width)
            self._fprev = prev_f
            self._fnew = fnew
            if stack2 is not None:
                self._stack = stack2
            if do_detect:
                self._feat_id_counter += self._add_cap
            self._feats = feats
            self._curr = curr
            self._last_track_obs = track_obs
            self._last_stats_dev = stat_vec  # fetched by failure_stats()
            self._last_dispatch_frames = 1
            self.stats.tock("update_idepths")
        else:
            # Cold path (bootstrap / early frames): separate dispatches.
            self.stats.tick("frame_creation")
            self._fprev = self._fnew
            if img_arg.ndim == 1:
                self._fnew = frame_mod.create_from_buf(
                    frame_id, q, t, img_arg, self.height, self.width,
                    p.pad)
            else:
                self._fnew = frame_mod.create(frame_id, q, t, img_arg,
                                              p.pad)
            self.stats.tock("frame_creation")
            if is_poseframe:
                self._stack = frame_mod.insert(
                    self._stack, self._curr_pf_slot, self._fnew)

            if self.num_imgs < 2 or self._curr_pf_slot is None:
                self.stats.tock("update")
                return False

            # Bootstrap detection (reference flame.cc:174-242): first
            # poseframe with no features yet.
            if not self.inited and is_poseframe and self._n_valid == 0:
                if p.solver.async_topology and self._packed_queue:
                    # Need a current mirror before bootstrap decisions:
                    # consume the newest queued transfer, discard older
                    # (their in-flight copies keep their in-flight slot
                    # until they land — zombies, like shed heads).
                    pk, pk_frame, pk_meta, pk_tent = self._packed_queue[-1]
                    for _pk, _fr, _m, _te in list(self._packed_queue)[:-1]:
                        self._zombie_fetches.append((_pk, _te))
                        if self._ba is not None:
                            self._note_ba_obs_drop(
                                sum(bool(f) for f in _m[1]))
                    self._packed_queue.clear()
                    self._sheds_since_consume = 0
                    self._consume_packed(pk.get(), pk_frame, pk_meta)
                    self._note_latency(pk, pk_tent)
                if self._n_valid == 0:
                    self._bootstrap_detect(self._curr_pf_slot)

            if self._n_valid == 0 and not self._packed_queue:
                self.stats.tock("update")
                return False

            # --- Track + measure + fuse + project + gate + detect +
            # pack: ONE device dispatch (detection on poseframes rides
            # along, reference detectFeatures via the detection thread,
            # flame.cc:822-1278; winners ride the same packed transfer).
            do_detect = bool(
                is_poseframe and self._fprev is not None
                and (p.detection.continuous or self.num_data_updates < 1))
            self.stats.tick("update_idepths")
            prev_q = self._fprev.q if self._fprev is not None \
                else self._fnew.q
            prev_t = self._fprev.t if self._fprev is not None \
                else self._fnew.t
            (feats, curr, member, stat_vec, track_obs,
             packed_dev) = pipeline.track_step(
                p, self.K, self.Kinv, self._stack, self._feats, self._fnew,
                self._curr_pf_slot, prev_q, prev_t, do_detect,
                jnp.int32(self._feat_id_counter), self._idepthmap)
            if do_detect:
                self._feat_id_counter += self._add_cap
            self._feats = feats
            self._curr = curr
            self._last_track_obs = track_obs
            self._last_stats_dev = stat_vec
            self._last_dispatch_frames = 1
            self.stats.tock("update_idepths")

        # Async pipelining: consume packed transfers staged on earlier
        # frames and triangulate them now, while the device chews on the
        # track dispatch above — the analogue of the reference's
        # thread pipelining (flame.cc:98-116). Detection winners ride the
        # same transfer and drain here too (the reference's detection
        # thread likewise delivers a frame late, flame.cc:737-757).
        if p.solver.async_topology:
            # Consume transfers that have landed. Flow control is the
            # bounded-shed policy (_drain_packed_queue): a stale head is
            # dropped, not joined, and only an exhausted shed budget
            # blocks — the depth cap (topology_lag) bounds the device
            # backlog the rest of the time. Delaunay + RCM run in a
            # second async stage (_consume_packed) so they never sit
            # inside any blocking path.
            if not self._drain_packed_queue():
                self.stats.tock("update")
                return False

        if self._n_valid == 0:
            self.stats.tock("update")
            return False

        if p.solver.async_topology:
            # Stage a new transfer only on stride frames and while fewer
            # than topology_lag are in flight — never block for room. The
            # fetch loop
            # free-runs at its natural cadence; detection no longer rides
            # it (winners insert on device in track_step).
            stride = max(int(p.solver.fetch_stride), 1)
            if (self.num_imgs % stride == 0 or not self.inited) and \
                    self._in_flight_fetches() < max(
                        int(p.solver.topology_lag), 1):
                self._packed_queue.append((
                    _AsyncFetch(packed_dev), self.num_imgs,
                    ([frame_id], [is_poseframe]),
                    [self._entry_stamp.pop(frame_id, None)]))
            elif self._ba is not None and is_poseframe:
                self._note_ba_obs_drop(1)
            # Adopt a finished triangulation (forced when nothing is
            # staged yet — bootstrap — so the first mesh appears asap).
            self._adopt_tri_result(
                force=bool(p.solver.deterministic)
                or self._staged_tris is None)
            if self._staged_tris is not None:
                self.stats.tick("sync_graph")
                (buf_dev, n_tris, tris_np, edges_np,
                 n_edges) = self._staged_tris
                self._tris_np = tris_np
                self._edges_np = edges_np
                self._n_edges = n_edges
                self._n_tris = n_tris
                self._run_post_delaunay(member, curr, buf_dev, n_tris)
                self.stats.tock("sync_graph")
        else:
            # Synchronous: fetch, triangulate, and run in-frame.
            if not self._consume_packed(np.asarray(packed_dev),
                                        self.num_imgs,
                                        ([frame_id], [is_poseframe])):
                self.stats.tock("update")
                return False
            self._adopt_tri_result(force=True)
            if self._staged_tris is None:
                self.stats.tock("update")
                return False
            (buf_dev, n_tris, tris_np, edges_np,
             n_edges) = self._staged_tris
            self.stats.tick("sync_graph")
            self._tris_np = tris_np
            self._edges_np = edges_np
            self._n_edges = n_edges
            self._n_tris = n_tris
            self._run_post_delaunay(member, curr, buf_dev, n_tris)
            self.stats.tock("sync_graph")

        if is_poseframe:
            self.stats.tick("pf_set_idepthmap")
            self._stack = frame_mod.set_idepthmap(
                self._stack, self._curr_pf_slot, self._idepthmap)
            self.stats.tock("pf_set_idepthmap")
        if self._ba is not None:
            # Advance the asynchronous BA pipeline (apply a landed solve
            # result / stage a new solve) — no blocking device reads
            # (ba/window.BundleAdjuster.step).
            self.stats.tick("ba")
            self._ba.step(self)
            self.stats.tock("ba")

        # Stats (reference flame.cc:428-437, 513-539). Coverage comes out
        # of the post-Delaunay dispatch and is fetched lazily (coverage()).
        self.stats.set("num_feats", self._n_valid)
        self.stats.set("num_vtx", getattr(self, "_n_members", 0))
        self.stats.set("num_tris", int(self._n_tris))
        self.stats.set("num_edges", int(self._n_edges))

        ms = self.stats.tock("update")
        if not p.debug_quiet:
            # Compact per-update timing line (reference flame.cc:545-549).
            print(f"flame_tpu/update({self.num_data_updates}, "
                  f"{self.num_regularizer_updates}) = {ms:4.1f}ms "
                  f"feats={self._n_valid} vtx={self._n_members} "
                  f"tris={self._n_tris}")
        if ms > 0:
            self.stats.ema("fps_max", 1000.0 / ms)
        # Wall-clock throughput incl. external latency between updates
        # (reference flame.cc:529-539).
        wall = self.stats.tock("fps")
        if wall > 0:
            self.stats.ema("fps", 1000.0 / wall)
        self.stats.tick("fps")

        self.inited = True
        self.num_data_updates += 1
        return True

    def _update_batch(self, frames) -> bool:
        """Dispatch frame_batch buffered frames as one fused device step
        (pipeline.batch_step): ONE coalesced upload (img_0 | ... | img_B-1
        | topology words) + ONE jit covering create/track/detect for every
        frame and the post-Delaunay section. Per-frame tracking semantics
        are the exact sequential semantics (a lax.scan over the per-frame
        body); smoothing/mesh run at batch cadence (the reference's
        free-running graph thread likewise decouples smoothing from the
        camera rate, flame.cc:98-112)."""
        p = self.params
        B = len(frames)
        self._coalesce = True

        prev_q, prev_t = self._fnew.q, self._fnew.t
        sync_q, sync_t = (self._last_sync_pose
                          if self._last_sync_pose is not None
                          else (prev_q, prev_t))

        def _pf_bookkeeping(fid, q, t, qn, tn):
            slot = self._alloc_pf_slot(fid)
            self._pf_slot_by_id[fid] = slot
            self._curr_pf_slot = slot
            self._curr_pf_id = fid
            if p.auto_poseframe:
                self._curr_pf_pose_np = (
                    qn if qn is not None else np.asarray(q, np.float64),
                    tn if tn is not None else np.asarray(t, np.float64))

        fids, qs, ts = [], [], []
        pf_flags, det_flags, pf_slots, id_bases = [], [], [], []
        for (_t, fid, q, t, img, is_pf, qnp, tnp) in frames:
            if is_pf:
                _pf_bookkeeping(fid, q, t, qnp, tnp)
            det = bool(is_pf and (p.detection.continuous
                                  or self.num_data_updates < 1))
            self.num_imgs += 1
            fids.append(fid)
            qs.append(q)
            ts.append(t)
            pf_flags.append(bool(is_pf))
            det_flags.append(det)
            pf_slots.append(self._curr_pf_slot)
            id_bases.append(self._feat_id_counter)
            if det:
                self._feat_id_counter += self._add_cap

        # ONE upload: img_0 | ... | img_B-1 | topology words. A freshly
        # adopted triangulation applies this dispatch (carry_fresh);
        # otherwise the last applied topology rides again, and re-applying
        # the same edges with carry_fresh=False passes the duals through
        # untouched.
        hw = self.height * self.width
        carry_fresh = False
        if self._pending_topo is not None:
            (tbuf, n_tris, tris_np, edges_np, n_edges) = self._pending_topo
            self._pending_topo = None
            self._fill_carry(tbuf, edges_np, n_edges)
            self._last_topo_host = tbuf
            self._topo_dev = None
            self._tris_np = tris_np
            self._edges_np = edges_np
            self._n_edges = n_edges
            self._n_tris = n_tris
            # Invalidate the single-path staging: the graph's edge arrays
            # move past it this dispatch, so re-applying it after a mode
            # fallback would mis-slot the carried duals.
            self._staged_tris = None
            self._staged_fresh = False
            carry_fresh = True
        resident = self._img_mode(frames[0][4]) == "resident"
        if resident:
            # Device-resident ingestion: only the topology words are
            # uploaded; the images are already in device memory
            # (DMA/PCIe-style camera feed, or the bench's pre-staged
            # frames). A STALE topology (carry_fresh False) is
            # byte-identical to the last upload, so the cached device copy
            # rides again — zero uploads that batch.
            if carry_fresh or self._topo_dev is None:
                self._topo_dev = jnp.asarray(
                    self._last_topo_host.view(np.uint8))
            buf_dev = self._topo_dev
            imgs = tuple(f[4] for f in frames)
        else:
            up = np.empty(B * hw + 2 * self._topo_words, np.uint8)
            for b, (_t, fid, q, t, img, is_pf, qnp, tnp) in \
                    enumerate(frames):
                up[b * hw: (b + 1) * hw] = img.reshape(-1)
            up[B * hw:] = self._last_topo_host.view(np.uint8)
            buf_dev = jnp.asarray(up)
            imgs = None

        self.stats.tick("update_idepths")
        (fnew2, stack2, feats, curr, member, stat_vec, obs_b,
         packed_dev, graph, vtx_idepths, normals, tri_validity, idepthmap,
         graph_scale, coverage) = pipeline.batch_step(
            p, self.K, self.Kinv, self._stack, self._feats, self._graph,
            self._graph_scale_dev, buf_dev,
            np.asarray(fids, np.int32), tuple(qs), tuple(ts),
            np.asarray(pf_flags, bool), np.asarray(det_flags, bool),
            np.asarray(pf_slots, np.int32),
            np.asarray(id_bases, np.int32),
            prev_q, prev_t, sync_q, sync_t, self._idepthmap,
            jnp.asarray(carry_fresh),
            n_frames=B, height=self.height, width=self.width, imgs=imgs,
            mesh=self._sharding_mesh)
        self.stats.tock("update_idepths")

        self._fprev = self._fnew
        self._fnew = fnew2
        self._stack = stack2
        self._feats = feats
        self._curr = curr
        self._last_stats_dev = stat_vec
        self._last_dispatch_frames = B
        self._last_track_obs = jax.tree.map(lambda a: a[-1], obs_b)
        self._graph = graph
        self._vtx_idepths = vtx_idepths
        self._vtx_normals = normals
        self._tri_validity = tri_validity
        self._idepthmap = idepthmap
        self._graph_scale_dev = graph_scale
        self._coverage = coverage
        q_last, t_last = frames[-1][2], frames[-1][3]
        self._last_sync_pose = (q_last, t_last)
        self._tris_staged = (self._tris_np, self._n_tris)
        if p.do_nltgv2:
            self.num_regularizer_updates += p.solver.n_iters_per_frame
        self._dispatches += 1

        # Async fetch pipeline — same bounded-shed flow control as the
        # single path (staleness age in frames, stride in dispatches).
        if not self._drain_packed_queue():
            self.stats.tock("update")
            return False

        stride = max(int(p.solver.fetch_stride), 1)
        if self._dispatches % stride == 0 and \
                self._in_flight_fetches() < max(
                    int(p.solver.topology_lag), 1):
            self._packed_queue.append((
                _AsyncFetch(packed_dev), self.num_imgs, (fids, pf_flags),
                [self._entry_stamp.pop(f, None) for f in fids]))
        elif self._ba is not None and any(pf_flags):
            self._note_ba_obs_drop(sum(bool(f) for f in pf_flags))
        self._adopt_tri_result(force=bool(p.solver.deterministic))

        if self._ba is not None:
            self.stats.tick("ba")
            self._ba.step(self)
            self.stats.tock("ba")

        self.stats.set("num_feats", self._n_valid)
        self.stats.set("num_vtx", self._n_members)
        self.stats.set("num_tris", int(self._n_tris))
        self.stats.set("num_edges", int(self._n_edges))

        ms = self.stats.tock("update")
        if not p.debug_quiet:
            print(f"flame_tpu/update_batch({self.num_data_updates}, "
                  f"{self.num_regularizer_updates}) = {ms:4.1f}ms "
                  f"feats={self._n_valid} vtx={self._n_members} "
                  f"tris={self._n_tris}")
        if ms > 0:
            self.stats.ema("fps_max", B * 1000.0 / ms)
        wall = self.stats.tock("fps")
        if wall > 0:
            self.stats.ema("fps", B * 1000.0 / wall)
        self.stats.tick("fps")

        self.num_data_updates += B
        return True

    # ------------------------------------------------------------------
    # Host helpers.
    # ------------------------------------------------------------------

    def _note_ba_obs_drop(self, n_pfs: int):
        """A dispatch's packed transfer was not staged (queue at
        topology_lag depth, fetch_stride skip, or a bootstrap clear), so
        its poseframes' BA observations never reach the store. The
        async design delivers observations at fetch cadence instead of
        with a blocking fetch per poseframe — the loss is rare (stride 1
        + the queue only fills when transfers lag the device) but must be
        COUNTED, not silent (no-silent-drops rule), and the bounded
        window solve tolerates thinned
        observations the way the mesh tolerates masked-stale topology."""
        self.stats.add("ba_obs_dropped_pfs", n_pfs)
        if not getattr(self, "_warned_ba_obs_drop", False):
            self._warned_ba_obs_drop = True
            import sys as _sys
            print("flame_tpu: BA observations dropped for a poseframe "
                  "(packed transfer not staged; see "
                  "stats['ba_obs_dropped_pfs'])", file=_sys.stderr)

    def _drain_packed_queue(self) -> bool:
        """Consume every packed transfer that has landed (all of them in
        deterministic mode). A stale in-flight head (age >= join_age) is
        SHED — popped without blocking, its un-cancellable transfer left
        to land in the background — so a slow transfer costs topology
        freshness instead of update() wall time: the reference
        never blocks its update thread either (threads free-run,
        flame.cc:98-116). Consecutive sheds are bounded
        (solver.max_consecutive_sheds); past the budget a stale head is
        joined BLOCKING. The bound is on DROPPED TRANSFERS between
        successful consumes — it keeps slow-but-landing transfers from
        cycling sheds forever. It is NOT a wall-clock drift bound:
        in a full transfer stall the queue empties (zombies hold the
        staging slots) and update() free-runs on device-only state with
        a frozen host mirror until the first landing — deliberately, as
        the reference's update thread free-runs when its detection
        thread starves, and a stalled transfer gives a block nothing to
        wait for but the stall itself. Sheds are counted
        (stats['packed_sheds']) and their poseframes' BA observations
        routed through _note_ba_obs_drop — never silent. Returns False
        when a consumed transfer cleared the instance. ONE definition
        for both dispatch modes."""
        p = self.params
        join_age = int(p.solver.join_age) or (
            max(int(p.solver.topology_lag), 1)
            * max(int(p.solver.fetch_stride), 1))
        shed_budget = max(int(p.solver.max_consecutive_sheds), 0)
        det = bool(p.solver.deterministic)
        joined_any = False
        while self._packed_queue:
            pk, pk_frame, pk_meta, pk_tent = self._packed_queue[0]
            ready = pk.ready()
            if not (det or ready):
                if self.num_imgs - pk_frame < join_age:
                    break  # young in-flight head: let it land on its own
                if self._sheds_since_consume < shed_budget:
                    # Shed the stale head. The post-stall topology
                    # refresh then comes from a FRESHER snapshot than
                    # this pre-stall one (feature positions move with
                    # the camera; a seconds-old member snapshot would
                    # triangulate geometry that no longer exists).
                    self._packed_queue.popleft()
                    self._zombie_fetches.append((pk, pk_tent))
                    self._sheds_since_consume += 1
                    self.stats.add("packed_sheds", 1)
                    # A shed head is an unready transfer: it must count
                    # in the readiness EMA or the stat reads lagging
                    # transfers as ready exactly when sheds fire.
                    self.stats.ema("fetch_ready_frac", 0.0, alpha=0.2)
                    if self._ba is not None:
                        self._note_ba_obs_drop(
                            sum(bool(f) for f in pk_meta[1]))
                    continue
                if joined_any:
                    break  # at most one blocking join per drain
            self._packed_queue.popleft()
            self.stats.tick("fetch_packed")
            self.stats.ema("fetch_ready_frac",
                           1.0 if ready else 0.0, alpha=0.2)
            pk_np = pk.get()
            joined_any = True
            self._sheds_since_consume = 0
            self.stats.tock("fetch_packed")
            if pk.t_done is not None:
                self.stats.ema("fetch_latency_ms",
                               1e3 * (pk.t_done - pk.t_start), alpha=0.2)
            self._note_latency(pk, pk_tent)
            if not self._consume_packed(pk_np, pk_frame, pk_meta):
                return False
        self._reap_zombies()
        return True

    def _reap_zombies(self):
        """Drop shed transfers that have landed (freeing their in-flight
        slot) and harvest their latency samples. A transfer error on a
        shed fetch is counted + warned once, not raised: the pipeline
        already moved on without its bytes, and a real device failure
        will surface on the next live dispatch."""
        if not self._zombie_fetches:
            return
        live = []
        for pk, tent in self._zombie_fetches:
            if not pk.ready():
                live.append((pk, tent))
                continue
            if pk._exc is not None:
                self.stats.add("zombie_fetch_errors", 1)
                if not getattr(self, "_warned_zombie_exc", False):
                    self._warned_zombie_exc = True
                    import sys as _sys
                    print("flame_tpu: shed packed transfer failed "
                          f"({type(pk._exc).__name__}); see "
                          "stats['zombie_fetch_errors']", file=_sys.stderr)
            else:
                self._note_latency(pk, tent)
        self._zombie_fetches = live

    def _in_flight_fetches(self) -> int:
        """Device->host transfers in flight: queued heads +
        shed-but-unlanded zombies. The staging depth cap (topology_lag)
        compares against this, so shedding never raises the true
        concurrent-transfer count."""
        self._reap_zombies()
        return len(self._packed_queue) + len(self._zombie_fetches)

    def _note_latency(self, pk, t_entries):
        """Record update()->map-host-visible latency samples for the
        frames of a landed packed transfer (the transfer is enqueued
        after its dispatch's compute, so t_done bounds when the dense
        map became fetchable)."""
        if pk.t_done is None or not t_entries:
            return
        for te in t_entries:
            if te is not None:
                self._latency_samples.append(1e3 * (pk.t_done - te))
        if len(self._latency_samples) > 8192:
            del self._latency_samples[:-4096]

    def latency_percentiles(self, qs=(50.0, 95.0)):
        """p50/p95 (default) of the measured update->map latency, ms.
        Samples exist only for dispatches that staged a packed fetch
        (stride frames with queue room — all of them at the defaults)
        plus shed transfers once they land. None when no samples yet."""
        if not self._latency_samples:
            return None
        return [float(v) for v in
                np.percentile(np.asarray(self._latency_samples), qs)]

    def _prepare_upload(self, img):
        """Stage this frame's host->device transfer. Returns the device
        image argument for frame creation: a (H*W [+ topo]) uint8 buffer
        on the coalesced path (ONE transfer carrying the image and, when
        a fresh triangulation is pending, the topology words; the split
        happens on device), else the image as a device array."""
        p = self.params
        self._coalesce = (p.solver.coalesce_uploads
                          and p.solver.async_topology
                          and isinstance(img, np.ndarray)
                          and img.dtype == np.uint8)
        if not self._coalesce:
            return jnp.asarray(img)
        hw = self.height * self.width
        if self._pending_topo is None:
            return jnp.asarray(img.reshape(-1))
        (tbuf, n_tris, tris_np, edges_np, n_edges) = self._pending_topo
        self._pending_topo = None
        self._fill_carry(tbuf, edges_np, n_edges)
        self._last_topo_host = tbuf  # applied this frame (pair-mode seed)
        self._topo_dev = None
        up = np.empty(hw + 2 * self._topo_words, np.uint8)
        up[:hw] = img.reshape(-1)
        up[hw:] = tbuf.view(np.uint8)
        buf_dev = jnp.asarray(up)
        self._staged_tris = (buf_dev, n_tris, tris_np, edges_np, n_edges)
        self._staged_offset = hw
        self._staged_fresh = True
        self._staged_frame = self.num_imgs
        return buf_dev

    def _host_triangulate(self, packed: np.ndarray):
        """Delaunay over the member features of a packed track transfer +
        edge/rank prep. Pure numpy/ctypes — safe to run inside the fetch
        worker thread, overlapping the triangulation with device
        compute (the analogue of the reference's graph thread running
        concurrently with update(), flame.cc:98-116). Returns None when
        there are too few members."""
        p = self.params
        self.stats.tick("triangulate")
        N = p.feature_capacity
        pk = packed[:N]
        member_np = (pk[:, 2] & pipeline.PACK_MEMBER) > 0
        member_slots = np.nonzero(member_np)[0]
        # Dedupe members that share a packed position (tracked features can
        # drift onto the same pixel; coincident input points make Delaunay
        # ill-posed and produce degenerate zero-length edges). The dropped
        # slot stays a graph member — it just holds no mesh edges until the
        # features separate (Shewchuk's Triangle likewise merges duplicate
        # input vertices).
        codes = (pk[member_slots, 0].astype(np.int64) << 16) \
            | pk[member_slots, 1].astype(np.int64)
        _, uniq_idx = np.unique(codes, return_index=True)
        n_dup = member_slots.shape[0] - uniq_idx.shape[0]
        if n_dup:
            member_slots = member_slots[np.sort(uniq_idx)]
        self.stats.set("members_deduped", n_dup)
        if member_slots.shape[0] < 3:
            self.stats.tock("triangulate")
            return None
        xy = pk[member_slots, :2].astype(np.float32) \
            * (1.0 / pipeline.PACK_XY_SCALE)
        try:
            tri = delaunay.triangulate(xy)
            if tri.triangles.shape[0] == 0:
                # Exactly-collinear member set: the native backend
                # returns ZERO triangles (it drops degenerate slivers)
                # rather than raising — same recovery as the raise path
                # below, or an empty topology would wipe the mesh.
                raise ValueError("degenerate (collinear) member set")
        except Exception:
            # Degenerate member geometry (e.g. all collinear): skip this
            # round's topology update — counted, not silent, not fatal
            # (the async worker re-raises real errors; this one has a
            # well-defined recovery: keep smoothing the old topology).
            self.stats.add("triangulate_degenerate", 1)
            self.stats.tock("triangulate")
            return None

        tris_slots = member_slots[tri.triangles]
        T_cap = p.triangle_capacity
        n_tris_dropped = max(tris_slots.shape[0] - T_cap, 0)
        if n_tris_dropped:
            tris_slots = tris_slots[:T_cap]
        n_tris = tris_slots.shape[0]

        # Unique undirected edges, canonical (lo, hi), sorted by code —
        # derived from the (possibly truncated) uploaded triangle set so
        # that every edge has a directed occurrence to point at.
        V = p.feature_capacity
        a = tris_slots.reshape(-1).astype(np.int64)  # corners 0,1,2 flat
        b = tris_slots[:, [1, 2, 0]].reshape(-1).astype(np.int64)
        dcode = np.minimum(a, b) * V + np.maximum(a, b)
        dorder = np.argsort(dcode, kind="stable")
        dsorted = dcode[dorder]
        first = np.ones(dsorted.shape[0], bool)
        first[1:] = dsorted[1:] != dsorted[:-1]
        E_cap = p.edge_capacity
        edge_src = dorder[first]  # index into the directed-edge list
        n_edges_dropped = max(edge_src.shape[0] - E_cap, 0)
        if n_edges_dropped:
            edge_src = edge_src[:E_cap]
        ucodes = dsorted[first][: edge_src.shape[0]]
        edges_sorted = np.stack([ucodes // V, ucodes % V], axis=1)
        n_edges = edges_sorted.shape[0]

        # Per-edge lengths order each vertex's incident-slot ranks
        # (shortest first): Delaunay degree is unbounded on clustered
        # member sets (hub vertices of 17-25 edges observed at VGA), so
        # slot-capacity overflow is made to drop the LONGEST incident
        # edges — the weakest alpha=1/len couplings — rather than
        # arbitrary ones.
        pos_by_slot = np.zeros((V, 2), np.float32)
        pos_by_slot[member_slots] = xy
        ed = pos_by_slot[edges_sorted[:, 0]] - pos_by_slot[edges_sorted[:, 1]]
        elen = np.sqrt((ed * ed).sum(axis=1))

        # ONE u16 upload: [n_tris, n_edges | tris flat | edge_src | ranks
        # | carry | perm (halo mode)]. The carry segment is filled by
        # _fill_carry at staging time (it must be computed against the
        # edges of the topology the device graph holds when THIS one is
        # applied).
        n_band_dropped = n_deg_dropped = 0
        buf = np.zeros(self._topo_words, np.uint16)
        buf[0] = n_tris
        buf[1] = n_edges
        buf[2: 2 + 3 * n_tris] = tris_slots.reshape(-1)
        buf[2 + 3 * T_cap: 2 + 3 * T_cap + n_edges] = edge_src
        if self._rank_layout:
            # RCM ordering of the members + banded edge ranks
            # (parallel/halo.py).
            from flame_tpu.parallel import halo as _halo
            mem = np.zeros(V, bool)
            mem[member_slots] = True
            perm = _halo.rcm_order(edges_sorted, n_edges, V, mem)
            inv = np.empty(V, np.int32)
            inv[perm] = np.arange(V, dtype=np.int32)
            ranks = _halo.perm_edge_ranks(edges_sorted, n_edges, inv, E_cap,
                                          p.solver.max_vertex_degree,
                                          p.solver.pallas_reach, tie=elen)
            buf[2 + 3 * T_cap + 3 * E_cap:] = perm.astype(np.uint16)
            n_rank_dropped = int((ranks[:n_edges, 0] == 255).sum())
            if n_rank_dropped:
                # Attribute the drop: RCM band overflow (raise
                # pallas_reach) vs per-vertex slot overflow (raise
                # max_vertex_degree) — the remedies differ.
                lo_p = inv[edges_sorted[:n_edges, 0]].astype(np.int64)
                hi_p = inv[edges_sorted[:n_edges, 1]].astype(np.int64)
                n_band_dropped = int((np.abs(lo_p // _halo.LANES
                                             - hi_p // _halo.LANES)
                                      > p.solver.pallas_reach).sum())
                n_deg_dropped = n_rank_dropped - n_band_dropped
            # The halo smoother additionally drops edges spanning more
            # ranks than its strip width (clamped to the per-device block
            # when V/n is small) — count them so the clamp is never a
            # SILENT truncation.
            n_dev = int(self._sharding_mesh.devices.size)
            halo_w = _halo.strip_width(V, n_dev, p.solver.pallas_reach)
            dist = np.abs(
                inv[edges_sorted[:n_edges, 0]].astype(np.int64)
                - inv[edges_sorted[:n_edges, 1]].astype(np.int64))
            extra = int(((dist > halo_w)
                         & (ranks[:n_edges, 0] != 255)).sum())
            n_band_dropped += extra
            n_rank_dropped += extra
        else:
            ranks = topology.build_edge_ranks(edges_sorted, V, E_cap,
                                              tie=elen)
            deg = p.solver.max_vertex_degree
            n_rank_dropped = int(
                ((ranks[:n_edges, 0] >= deg)
                 | (ranks[:n_edges, 1] >= deg)).sum())
            # Vertex-mode rank drops are by definition incidence-slot
            # (degree) overflows; no band exists.
            n_deg_dropped = n_rank_dropped
        rk = (np.minimum(ranks[:, 0], 255).astype(np.uint16)
              | (np.minimum(ranks[:, 1], 255).astype(np.uint16) << 8))
        buf[2 + 3 * T_cap + E_cap: 2 + 3 * T_cap + 2 * E_cap] = rk

        # No silent capacity truncation: every dropped
        # triangle/edge is counted into the stats snapshot, and the first
        # occurrence warns — a mis-sized config must not degrade quality
        # invisibly.
        self.stats.set("tris_truncated", n_tris_dropped)
        self.stats.set("edges_truncated", n_edges_dropped)
        self.stats.set("edges_rank_dropped", n_rank_dropped)
        self.stats.set("edges_band_dropped", n_band_dropped)
        self.stats.set("edges_degree_dropped", n_deg_dropped)
        if (n_tris_dropped or n_edges_dropped or n_rank_dropped) \
                and not self._warned_capacity:
            self._warned_capacity = True
            import sys as _sys
            print(f"flame_tpu: capacity drops (tris={n_tris_dropped}, "
                  f"edges={n_edges_dropped}, band={n_band_dropped}, "
                  f"degree={n_deg_dropped}); raise triangle/edge "
                  f"capacity, pallas_reach (band) or max_vertex_degree "
                  f"(degree)", file=_sys.stderr)
        self.stats.tock("triangulate")
        return (buf, n_tris, tris_slots, edges_sorted, n_edges)

    def _fill_carry(self, buf: np.ndarray, edges_sorted: np.ndarray,
                    n_edges: int):
        """Write the dual carry segment of a topo buffer: for each new
        edge, the slot of the same vertex pair in the LAST APPLIED edge
        arrays (0xFFFF when the pair is new — reference flame.cc:2094-2104
        keeps duals on surviving pairs). Main-thread numpy; replaces a
        device-side binary search per frame."""
        p = self.params
        T_cap, E_cap = p.triangle_capacity, p.edge_capacity
        V = p.feature_capacity
        carry = np.full(E_cap, 0xFFFF, np.uint16)
        n_prev = self._n_edges
        if n_prev and n_edges:
            prev = self._edges_np[:n_prev]
            pcodes = prev[:, 0].astype(np.int64) * V + prev[:, 1]
            ncodes = edges_sorted[:n_edges, 0].astype(np.int64) * V \
                + edges_sorted[:n_edges, 1]
            pos = np.searchsorted(pcodes, ncodes)
            posc = np.minimum(pos, n_prev - 1)
            match = pcodes[posc] == ncodes
            carry[:n_edges] = np.where(match, posc, 0xFFFF).astype(np.uint16)
        buf[2 + 3 * T_cap + 2 * E_cap: 2 + 3 * T_cap + 3 * E_cap] = carry

    def _consume_packed(self, packed: np.ndarray,
                        packed_frame: int = None, meta=None) -> bool:
        """Digest a packed track transfer: update host mirrors, run the
        too-few-features lifecycle checks, and kick off the asynchronous
        triangulation of the member set (joined later by
        _adopt_tri_result). Returns False when the frame cannot proceed
        (reference flame.cc:281-290 / syncGraph early-outs).

        packed_frame: num_imgs at the time the transfer was staged. The
        snapshot reflects all device-side insertions up to that frame
        (insert_detections runs before packing), so the mirror needs no
        add-protection bookkeeping.

        meta: (fids, pf_flags) of the dispatch that staged the transfer
        — the BA layer attributes the widened transfer's per-frame
        observations with it (ba/window.split_packed layout)."""
        p = self.params
        N = p.feature_capacity
        if self._ba is not None:
            from flame_tpu.ba import window as ba_window
            packed, ba_snap = ba_window.split_packed(p, packed)
            if ba_snap is not None and meta is not None:
                self._ba.ingest_snapshot(ba_snap, *meta)
        packed = packed[:N]
        flags = packed[:, 2]
        member_np = (flags & pipeline.PACK_MEMBER) > 0
        self._feat_valid_np = (flags & pipeline.PACK_FEAT_VALID) > 0
        self._n_valid = int(self._feat_valid_np.sum())
        self._n_members = int(member_np.sum())

        n_valid = int(((flags & pipeline.PACK_CURR_VALID) > 0).sum())
        if n_valid < 3:
            if not p.debug_quiet:
                print(f"flame_tpu: too few features ({n_valid}); clearing")
            self.clear()
            return False

        # Second async stage: Delaunay + RCM in their own worker so their
        # cost never extends the blocking fetch join. A still-unjoined
        # previous result is adopted first — joined FORCIBLY if the
        # worker is mid-flight (never dropped: when two transfers drain
        # in one update, overwriting the pending handle would orphan a
        # nearly-finished triangulation; its staleness masking is no
        # worse than skipping a topology update).
        self._adopt_tri_result(
            force=bool(p.solver.deterministic)
            or self._tri_pending is not None)
        self._tri_pending = (_AsyncWork(
            lambda pk=packed: self._host_triangulate(pk)), packed_frame)
        return True

    def _adopt_tri_result(self, force: bool):
        """Join the pending async triangulation if done (or force) and
        stage its topology upload. The upload stays on the main thread so
        the device queue keeps a single dispatcher."""
        if self._tri_pending is None:
            return
        work, frame = self._tri_pending
        if not (force or work.ready()):
            return
        self._tri_pending = None
        tri_result = work.get()
        if tri_result is None:  # too few members to triangulate
            return
        buf, n_tris, tris_slots, edges_sorted, n_edges = tri_result
        if getattr(self, "_coalesce", False):
            # Stash host-side; the words ride the next frame's image
            # upload (one transfer) and stage there.
            self._pending_topo = tri_result
            return
        self._fill_carry(buf, edges_sorted, n_edges)
        # This NEWER triangulation supersedes any older batch-stashed one
        # (a mode transition could otherwise re-apply the stale pending
        # topology over this one when batching re-engages).
        self._pending_topo = None
        self._last_topo_host = buf
        self._topo_dev = None
        self.stats.tick("topo_upload")
        buf_dev = jnp.asarray(buf)
        self.stats.tock("topo_upload")
        self._staged_tris = (buf_dev, n_tris, tris_slots,
                             edges_sorted, n_edges)
        self._staged_offset = 0
        self._staged_fresh = True
        self._staged_frame = frame if frame is not None else self.num_imgs

    def _run_post_delaunay(self, member, curr, topo_buf, n_tris: int):
        """Dispatch the fused topology+sync+smooth+mesh step. topo_buf is
        the single packed u16 topology upload (see _host_triangulate)."""
        p = self.params
        # Project graph idepths from the pose of the frame whose PIXEL
        # COORDINATES the graph currently holds — the last frame a sync
        # ran for. That is the previous frame only when no frame skipped
        # post-Delaunay in between (bootstrap, batch->single fallback);
        # _last_sync_pose tracks it exactly.
        fprev = self._fprev if self._fprev is not None else self._fnew
        sync_pose = (self._last_sync_pose
                     if self._last_sync_pose is not None
                     else (fprev.q, fprev.t))
        (self._graph, self._vtx_idepths, self._vtx_normals,
         self._tri_validity, self._idepthmap,
         self._graph_scale_dev, self._coverage) = pipeline.post_delaunay_step(
            p, self.K, self.Kinv, self._graph, member, curr,
            sync_pose, (self._fnew.q, self._fnew.t),
            self._graph_scale_dev, self.width, self.height,
            self._idepthmap if p.init_with_prediction else None,
            topo_buf=topo_buf, topo_offset=self._staged_offset,
            carry_fresh=jnp.asarray(self._staged_fresh),
            mesh=self._sharding_mesh)
        self._staged_fresh = False
        self._last_sync_pose = (self._fnew.q, self._fnew.t)
        # Triangle array + mask are derived lazily by the output getters
        # from the host copy (off the per-frame path).
        self._tris_staged = (self._tris_np, n_tris)
        if p.do_nltgv2:
            self.num_regularizer_updates += p.solver.n_iters_per_frame

    def _want_poseframe(self, q_np: np.ndarray, t_np: np.ndarray) -> bool:
        """Automatic poseframe decision (params.auto_poseframe): declare a
        new poseframe when the current one has become a poor stereo
        reference for incoming frames — probe disparity past the target,
        or orientation/overlap hard-reject in the keyframe score."""
        if self._curr_pf_slot is None or self._curr_pf_pose_np is None:
            return True
        p = self.params
        q_pf, t_pf = self._curr_pf_pose_np
        q_rel, t_rel = keyframe.KeyframeSelector._relative(
            q_pf, t_pf, q_np, t_np)
        K_np = np.asarray(self.K, np.float64)
        Kinv_np = np.asarray(self.Kinv, np.float64)
        disp = keyframe.test_disparity(
            K_np, Kinv_np, q_rel, t_rel,
            (self.width / 2.0, self.height / 2.0), p.auto_pf_depth)
        if disp >= p.auto_pf_max_disparity:
            return True
        s = keyframe.score(self.width, self.height, K_np, Kinv_np,
                           q_rel, t_rel)
        return s <= -np.finfo(np.float32).max / 2

    def _alloc_pf_slot(self, frame_id: int) -> int:
        if self._pf_free:
            return self._pf_free.pop()
        # Auto-evict the oldest poseframe (the external BA layer normally
        # prunes; the reference relies on prunePoseFrames, flame.cc:554-706).
        # defer_mirror: the validity mirror refreshes with the next packed
        # transfer anyway; a blocking fetch here drains the whole device
        # queue.
        live = sorted(self._pf_slot_by_id.keys())
        self.prune_poseframes(live[1:], defer_mirror=True)
        return self._pf_free.pop()

    def coverage(self) -> float:
        """Fraction of pixels covered by the dense idepthmap
        (reference flame.cc:428-437)."""
        return float(self._coverage) if self._coverage is not None else 0.0

    def _bootstrap_detect(self, pf_slot: int):
        """First-poseframe detection + device-side insertion (reference
        flame.cc:174-242). One dispatch + one valid-mask fetch to prime the
        host mirror (one-time; steady-state detection rides track_step)."""
        if self._fprev is None:
            return
        self._feats, valid_dev = pipeline.bootstrap_detect(
            self.params, self.K, self.Kinv, self._stack, self._feats,
            self._fprev.q, self._fprev.t, pf_slot, self._idepthmap,
            jnp.int32(self._feat_id_counter), self._curr.xy,
            self._curr.valid)
        self._feat_id_counter += self._add_cap
        self._feat_valid_np = np.asarray(valid_dev)
        self._n_valid = int(self._feat_valid_np.sum())

    # ------------------------------------------------------------------
    # Map maintenance (reference flame.h:155-179, flame.cc:554-706).
    # ------------------------------------------------------------------

    def update_poseframe_poses(self, poses: Dict[int, Tuple]):
        """External pose updates (e.g. from BA / pose-graph relinearization);
        reference updatePoseFramePoses (flame.h:155-164)."""
        self._flush_batch()
        for fid, (q, t) in poses.items():
            slot = self._pf_slot_by_id.get(fid)
            if slot is not None:
                self._stack = frame_mod.set_pose(
                    self._stack, slot, jnp.asarray(q, jnp.float32),
                    jnp.asarray(t, jnp.float32))

    def prune_poseframes(self, keep_ids, defer_mirror: bool = False):
        """Drop all poseframes not in keep_ids, re-anchoring their features
        onto the newest survivor (reference flame.cc:554-706). Pure host
        bookkeeping (_pf_slot_by_id mirrors the device stack) plus one
        re-anchoring dispatch — no device fetch unless defer_mirror is
        False (external callers get an immediately consistent validity
        mirror; the internal auto-evict path defers to the next packed
        transfer)."""
        self._flush_batch()
        keep = set(int(i) for i in keep_ids)
        if self._curr_pf_id is not None and self._curr_pf_id not in keep:
            # Hard contract, matching the reference's assumption that the
            # current poseframe survives pruning (flame.cc:554-706 never
            # deletes curr_pf_): silently ignoring the request would leave
            # an external estimator's bookkeeping out of sync.
            raise ValueError(
                f"prune_poseframes: current poseframe "
                f"{self._curr_pf_id} missing from keep_ids")

        kill = {fid: slot for fid, slot in self._pf_slot_by_id.items()
                if fid not in keep}
        if not kill:
            return
        surv = [fid for fid in self._pf_slot_by_id if fid in keep]
        if not surv:
            self.clear()
            for fid, s in kill.items():
                self._stack = frame_mod.remove(self._stack, s)
                self._pf_slot_by_id.pop(fid, None)
                self._pf_free.append(int(s))
            self._curr_pf_slot = None
            self._curr_pf_id = None
            return
        # Newest survivor (reference uses crbegin = highest id,
        # flame.cc:607).
        target = self._pf_slot_by_id[max(surv)]

        kill_mask = np.zeros(self.params.poseframe_capacity, bool)
        for s in kill.values():
            kill_mask[s] = True
        b = self.params.border
        self._feats = pipeline.reanchor_features(
            self._feats, self.K, self.Kinv, self._stack,
            jnp.asarray(kill_mask), target, float(b),
            float(self.width - b), float(self.height - b))
        if self._ba is not None:
            self._ba.store.drop_frames(kill.keys())
        for fid, s in kill.items():
            self._stack = frame_mod.remove(self._stack, s)
            self._pf_slot_by_id.pop(fid, None)
            self._pf_free.append(int(s))
        if not defer_mirror:
            # Re-anchoring may have invalidated features; refresh now.
            self._refresh_feat_mirror()

    def clear(self):
        """Reset features/graph/mesh; poseframes survive (reference
        flame.h:179-202)."""
        p = self.params
        self.inited = False
        self._feats = pipeline.empty_features(p.feature_capacity)
        self._graph = nltgv2.empty(p.feature_capacity, p.edge_capacity,
                                   p.solver.max_vertex_degree)
        self._curr = pipeline.CurrFeatures(
            xy=jnp.zeros((p.feature_capacity, 2), jnp.float32),
            idepth=jnp.zeros(p.feature_capacity),
            var=jnp.zeros(p.feature_capacity),
            valid=jnp.zeros(p.feature_capacity, bool))
        self._tri_mask = jnp.zeros_like(self._tri_mask)
        self._tri_validity = jnp.zeros_like(self._tri_validity)
        self._vtx_idepths = jnp.zeros_like(self._vtx_idepths)
        self._vtx_normals = jnp.zeros_like(self._vtx_normals)
        self._idepthmap = jnp.full((self.height, self.width), jnp.nan,
                                   jnp.float32)
        self._coverage = None
        self._n_members = 0
        self._n_tris = 0
        self._n_edges = 0
        self._tris_np = np.zeros((0, 3), np.int64)
        self._tris_staged = None
        self._staged_tris = None
        self._tri_pending = None
        self._staged_frame = None
        self._pending_topo = None
        self._staged_offset = 0
        self._batch_pending = []
        self._last_topo_host = None
        self._topo_dev = None
        self._last_sync_pose = None
        # In-flight transfers of the cleared state: un-cancellable — keep
        # them on the zombie list so the in-flight depth accounting stays
        # honest, discard their bytes when they land.
        for pk, _fr, _m, tent in self._packed_queue:
            self._zombie_fetches.append((pk, None))
        self._packed_queue.clear()
        self._sheds_since_consume = 0
        self._entry_stamp.clear()
        self._feat_valid_np = np.zeros(p.feature_capacity, bool)
        self._n_valid = 0

    def _refresh_feat_mirror(self):
        """Re-sync the host validity mirror from the device (used after
        rare ops that mutate validity outside the tracked path)."""
        self._feat_valid_np = np.asarray(self._feats.valid).copy()
        self._n_valid = int(self._feat_valid_np.sum())

    # ------------------------------------------------------------------
    # Outputs (reference flame.h:207-280).
    # ------------------------------------------------------------------

    def get_inverse_depth_map(self) -> np.ndarray:
        """Dense idepthmap over all triangles (reference flame.h:207-210)."""
        self._flush_batch()
        return np.asarray(self._idepthmap)

    def _ensure_tris(self):
        """Materialize the device triangle array + mask from the host copy
        (deferred off the per-frame path; see _run_post_delaunay)."""
        if self._tris_staged is not None:
            tris_np, n_tris = self._tris_staged
            T = self.params.triangle_capacity
            full = np.zeros((T, 3), np.int32)
            full[:n_tris] = tris_np[:n_tris]
            mask = np.zeros((T,), bool)
            mask[:n_tris] = True
            self._tris = jnp.asarray(full)
            self._tri_mask = jnp.asarray(mask)
            self._tris_staged = None

    def get_filtered_inverse_depth_map(self) -> np.ndarray:
        """Dense idepthmap over filter-passing triangles only
        (reference flame.h:217-228)."""
        self._flush_batch()
        self._ensure_tris()
        img = rasterize.rasterize(
            self._graph.pos, self._tris, self._vtx_idepths,
            self._tri_mask & self._tri_validity, self.height, self.width)
        return np.asarray(img)

    def get_inverse_depth_mesh(self):
        """Compacted mesh (reference flame.h:233-249): dict with vertices,
        idepths, w1, w2, normals, triangles, tri_validity, edges (all np,
        triangle/edge indices into the compacted vertex list)."""
        self._flush_batch()
        self._ensure_tris()
        member = np.asarray(self._graph.vtx_mask)
        slots = np.nonzero(member)[0]
        remap = np.full(member.shape[0], -1, np.int64)
        remap[slots] = np.arange(slots.shape[0])
        tris = remap[np.asarray(self._tris)[: self._n_tris]]
        edges = remap[self._edges_np[: self._n_edges]]
        validity = np.asarray(self._tri_validity)[: self._n_tris]
        # Membership can have shrunk since the triangulation was built
        # (e.g. after clear()/prune); drop rows touching dead vertices.
        tri_ok = np.all(tris >= 0, axis=1) if tris.size else \
            np.zeros(0, bool)
        edge_ok = np.all(edges >= 0, axis=1) if edges.size else \
            np.zeros(0, bool)
        return {
            "vertices": np.asarray(self._graph.pos)[slots],
            "idepths": np.asarray(self._vtx_idepths)[slots],
            "w1": np.asarray(self._graph.w1)[slots],
            "w2": np.asarray(self._graph.w2)[slots],
            "normals": np.asarray(self._vtx_normals)[slots],
            "triangles": tris[tri_ok],
            "tri_validity": validity[tri_ok],
            "edges": edges[edge_ok],
        }

    def get_raw_idepths(self):
        """Valid current-frame features (reference flame.h:255-273):
        (vertices (M, 2), idepth_mu (M,), idepth_var (M,))."""
        self._flush_batch()
        v = np.asarray(self._curr.valid)
        return (np.asarray(self._curr.xy)[v],
                np.asarray(self._curr.idepth)[v],
                np.asarray(self._curr.var)[v])

    # ------------------------------------------------------------------
    # Debug images (reference flame.h:286-309), rendered on demand.
    # ------------------------------------------------------------------

    def _gray(self) -> np.ndarray:
        if self._fnew is None:
            return np.zeros((self.height, self.width), np.uint8)
        return np.clip(np.asarray(self._fnew.img), 0, 255).astype(np.uint8)

    def get_debug_image_wireframe(self) -> np.ndarray:
        from flame_tpu.utils import visualization
        mesh = self.get_inverse_depth_mesh()
        return visualization.draw_wireframe(
            self._gray(), mesh["vertices"], mesh["idepths"],
            mesh["triangles"], mesh["tri_validity"],
            scale=self.params.scene_color_scale)

    def get_debug_image_features(self) -> np.ndarray:
        from flame_tpu.utils import visualization
        verts, mu, _ = self.get_raw_idepths()
        return visualization.draw_features(
            self._gray(), verts, mu, scale=self.params.scene_color_scale)

    def get_debug_image_idepthmap(self) -> np.ndarray:
        from flame_tpu.utils import visualization
        return visualization.draw_idepthmap(
            self._gray(), self.get_inverse_depth_map(),
            scale=self.params.scene_color_scale)

    def get_debug_image_normals(self) -> np.ndarray:
        from flame_tpu.utils import visualization
        mesh = self.get_inverse_depth_mesh()
        return visualization.draw_normals(
            self._gray(), mesh["vertices"], mesh["normals"],
            mesh["triangles"], mesh["tri_validity"])

    def get_debug_image_detections(self) -> np.ndarray:
        """Detection score map + last staged winners (reference
        drawDetections, flame.cc:2363-2403). Runs detection afresh on the
        current poseframe."""
        from flame_tpu.utils import visualization
        if self._fprev is None or self._curr_pf_slot is None:
            return visualization.to_rgb(self._gray())
        p = self.params
        # Compare against the newest frame that is not the poseframe itself
        # (right after a non-poseframe update, _fprev IS the poseframe, and
        # a zero-baseline geometry would blank the score map).
        new_is_pf = (self._pf_slot_by_id.get(int(self._fnew.frame_id))
                     == self._curr_pf_slot)
        cmp_frame = self._fprev if new_is_pf else self._fnew
        geo = _load_rel(self.K, self.Kinv,
                        (self._stack.q[self._curr_pf_slot],
                         self._stack.t[self._curr_pf_slot]),
                        (cmp_frame.q, cmp_frame.t))
        res = detection.detect(
            geo, self._stack.gradx[self._curr_pf_slot],
            self._stack.grady[self._curr_pf_slot],
            p.detection.min_grad_mag, p.detection.win_size, p.border)
        score = np.asarray(res.score_map)
        winners = np.asarray(res.best_xy)[np.asarray(res.best_score) > 0]
        return visualization.draw_detections(self._gray(), score, winners)

    def get_debug_image_matches(self) -> np.ndarray:
        """Features colored by the last search outcome, matching the
        reference's drawMatches palette (flame.cc:1699-1746, BGR there):
        ref-patch gradient fail = cyan (white while the feature has no
        updates yet), ambiguous = red, max cost = yellow; success blends
        blue -> green over num_updates 0..30 (the reference's
        utils::blendColor draw)."""
        from flame_tpu.utils import visualization
        img = visualization.to_rgb(self._gray())
        xy = np.asarray(self._curr.xy)
        valid = np.asarray(self._curr.valid)
        status = np.asarray(self._feats.search_status)
        nupd = np.asarray(self._feats.num_updates)
        Hh, Ww = img.shape[:2]
        for s in np.nonzero(valid)[0]:
            x, y = int(round(xy[s, 0])), int(round(xy[s, 1]))
            st = int(status[s])
            if st == 1:  # FAIL_REF_PATCH_GRADIENT
                c = (255, 255, 255) if nupd[s] == 0 else (0, 255, 255)
            elif st == 2:  # FAIL_AMBIGUOUS_MATCH
                c = (255, 0, 0)
            elif st == 3:  # FAIL_MAX_COST
                c = (255, 255, 0)
            else:  # SUCCESS: blue -> green by update count
                a = min(max(nupd[s] / 30.0, 0.0), 1.0)
                c = (0, int(255 * a), int(255 * (1 - a)))
            img[max(0, y - 2):min(Hh, y + 3),
                max(0, x - 2):min(Ww, x + 3)] = c
        return img

    def failure_stats(self) -> Dict[str, int]:
        """Failure counters of the LAST DEVICE DISPATCH: one frame on the
        per-frame path, frame_batch frames summed under batching (the
        'frames_counted' key says which — normalize by it when comparing
        across dispatch modes)."""
        self._flush_batch()
        s = np.asarray(self._last_stats_dev)
        self.stats.set("num_idepth_updates", int(s[pipeline.STAT_UPDATES]))
        return {
            "frames_counted": int(getattr(self, "_last_dispatch_frames", 1)),
            "updates": int(s[pipeline.STAT_UPDATES]),
            "fail_max_var": int(s[pipeline.STAT_FAIL_MAX_VAR]),
            "fail_max_dropouts": int(s[pipeline.STAT_FAIL_MAX_DROPOUTS]),
            "fail_ref_patch_grad": int(s[pipeline.STAT_FAIL_REF_PATCH]),
            "fail_ambiguous_match": int(s[pipeline.STAT_FAIL_AMBIGUOUS]),
            "fail_max_cost": int(s[pipeline.STAT_FAIL_MAX_COST]),
            # Rasterizer bin overflows in the batch's per-frame dense
            # maps (batched path; the maps stay exact, see ops/rasterize).
            "raster_bin_overflow": int(s[pipeline.STAT_RASTER_OVERFLOW]),
            # Capacity-drop counters from the last triangulation (0 when
            # nothing was truncated; no silent capacity drops).
            "tris_truncated": int(self.stats.stats("tris_truncated")),
            "edges_truncated": int(self.stats.stats("edges_truncated")),
            "edges_rank_dropped": int(
                self.stats.stats("edges_rank_dropped")),
            # Cause split of rank drops (halo smoother): RCM band
            # overflow -> raise solver.pallas_reach; per-vertex
            # slot overflow -> raise solver.max_vertex_degree.
            "edges_band_dropped": int(
                self.stats.stats("edges_band_dropped")),
            "edges_degree_dropped": int(
                self.stats.stats("edges_degree_dropped")),
            "members_deduped": int(self.stats.stats("members_deduped")),
        }
