"""Configuration tree for flame_tpu.

Mirrors the reference's nested parameter structs (a single flat struct with
nested sub-params: /root/reference/src/flame/params.h:36-143,
stereo/inverse_depth_filter.h:48-68, stereo/line_stereo.h:47-59,
stereo/inverse_depth_meas_model.h:44-52,
optimizers/nltgv2_l1_graph_regularizer.h:121-129) but as frozen dataclasses
so a Params instance can be closed over by jitted functions (all fields are
static Python scalars; changing one triggers a recompile, which matches how
the reference treats params as fixed at construction).

Additions: fixed capacities (features/vertices/edges/keyframes)
that bound every device array, and solver scheduling knobs (smoothing
iterations per frame replaces the reference's free-running graph thread,
flame.cc:98-112).
"""

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LineStereoParams:
    """Epipolar line search parameters (reference: line_stereo.h:47-59)."""

    max_cost: float = 1300.0  # Max 5-sample SSD for a valid match.
    do_subpixel: bool = True  # Subpixel refinement via error-gradient zero crossing.
    sample_dist: float = 1.0  # Distance in pixels between samples.
    second_best_factor: float = 1.5  # best*factor must beat second best.
    # Store ALL packed-corner sample tables in bf16: the line-stereo
    # [N, S] gather's per-frame table AND the persistent poseframe-stack
    # table (FrameStack.img_pack) that serves ref-patch and BA-rematch
    # sampling. Halves the gathered bytes and is EXACT for u8-sourced
    # images — bf16 represents integers 0..255 exactly, and
    # interpolation weights stay f32, so results are bit-identical to
    # f32 tables for the reference's image domain. Disable for float
    # imagery with structure below ~2^-8 relative (all the paths above
    # then revert to f32 tables together).
    table_bf16: bool = True


@dataclass(frozen=True)
class MeasModelParams:
    """LSD-SLAM inverse-depth noise model (reference: inverse_depth_meas_model.h:44-52)."""

    win_size: int = 5  # Window size used for image padding.
    pixel_var: float = 16.0  # Photometric noise variance (intensity^2).
    epipolar_line_var: float = 1.0  # Geometric epipolar line noise variance (px^2).


@dataclass(frozen=True)
class FilterParams:
    """Per-feature inverse-depth filter (reference: inverse_depth_filter.h:48-68)."""

    win_size: int = 5  # Patch size along the epiline (must be 5).
    search_sigma: float = 2.0  # Search region = mu +/- search_sigma * sigma.
    min_grad_mag: float = 5.0  # Min |d(ref patch)| to attempt a match.
    idepth_min: float = 1e-3  # Inverse depth search bounds.
    idepth_max: float = 2.0
    epilength_min: float = 3.0  # Epipolar segment length bounds (pixels).
    epilength_max: float = 32.0
    process_var_factor: float = 1.01  # Variance inflation per frame.
    process_fail_var_factor: float = 1.1  # Variance inflation on failed track.
    sparams: LineStereoParams = dataclasses.field(default_factory=LineStereoParams)


@dataclass(frozen=True)
class RegularizerParams:
    """NLTGV2-L1 Chambolle-Pock (reference: nltgv2_l1_graph_regularizer.h:121-129)."""

    data_factor: float = 0.1  # lambda in the TV literature.
    step_x: float = 0.001  # Primal step size.
    step_q: float = 125.0  # Dual step size.
    theta: float = 0.25  # Extragradient overrelaxation.
    x_min: float = 0.0  # Feasible set for the primal variable.
    x_max: float = 10.0


@dataclass(frozen=True)
class TriangleFilterParams:
    """Display-mesh triangle filters (reference: params.h:69-85)."""

    do_oblique_filter: bool = True
    oblique_normal_thresh: float = 1.39626  # 80 deg view-ray/normal angle.
    oblique_idepth_diff_factor: float = 0.35  # (max-min)/max idepth ratio gate.
    oblique_idepth_diff_abs: float = 0.1  # absolute (max-min) idepth gate.
    do_edge_length_filter: bool = True
    edge_length_thresh: float = 0.333  # Fraction of image width.
    do_idepth_filter: bool = True
    min_triangle_idepth: float = 0.01


@dataclass(frozen=True)
class DetectionParams:
    """Gradient-grid feature detection (reference: params.h:44-53, flame.cc:1192-1262)."""

    continuous: bool = True  # Detect on every poseframe (vs first only).
    win_size: int = 16  # One feature per win_size x win_size cell.
    do_letterbox: bool = False  # Restrict to middle third of rows.
    min_grad_mag: float = 5.0  # Gradient magnitude threshold (params.h:39).


@dataclass(frozen=True)
class SolverParams:
    """Solver scheduling (replaces the free-running graph thread,
    reference flame.cc:98-112, with a deterministic iteration budget)."""

    # Chambolle-Pock iterations per update(). The reference's free-running
    # graph thread achieves roughly this per-frame rate on comparable graph
    # sizes (hash-map edge traversal ~3 ms/iteration at 16k edges).
    n_iters_per_frame: int = 40
    max_vertex_degree: int = 16  # Capacity of the per-vertex incidence table.
    # Smoother implementation (core.pipeline.resolve_smoother): "auto" and
    # "vertex" run the XLA vertex-centric formulation
    # (nltgv2._smooth_vertex_centric); "halo" partitions the vertices over
    # a device mesh with ppermute boundary exchange (parallel/halo.py,
    # ShardedFlame only).
    smoother: str = "auto"
    # Band reach of the halo smoother's RCM ordering, in rows of
    # parallel.halo.LANES ranks: edges whose endpoints' rank rows differ by
    # more than this are left unsmoothed for the frame (counted in
    # failure_stats()['edges_band_dropped']). The halo strip width is
    # (pallas_reach + 1) * LANES ranks, clamped to the per-device block.
    pallas_reach: int = 2
    # Lagged triangulation: smooth on a topology that is topology_lag
    # frames old while the host triangulates newer member sets in parallel
    # — the analogue of the reference's free-running graph thread
    # decoupling (flame.cc:98-112). Edges/triangles touching vertices that
    # left the graph are masked out, so staleness is inert. Lag 2 hides the
    # device->host fetch of the member positions behind a whole frame.
    async_topology: bool = False
    # Maximum in-flight packed transfers. The fetch loop free-runs:
    # transfers are consumed when ready, new ones staged only while fewer
    # than this many are in flight (never blocking for room), so the
    # post-Delaunay dispatch never waits on a device->host transfer at
    # steady state.
    topology_lag: int = 2
    # Stage a packed transfer every fetch_stride-th update. Detection
    # inserts on device (never rides the fetch), so skipping fetches only
    # ages the Delaunay topology — masked-inert staleness the mesh
    # filters absorb — while relaxing the per-frame fetch-join pressure:
    # steady-state wall time is bounded below by
    # fetch_latency / (topology_lag * fetch_stride).
    fetch_stride: int = 1
    # Age (in frames) at which the head transfer is considered STALE.
    # 0 -> topology_lag * fetch_stride. A stale in-flight head is SHED
    # (popped without blocking; see max_consecutive_sheds) so a slow
    # transfer costs topology freshness, never update() wall time — the
    # reference likewise never blocks its update thread on anything
    # (threads free-run, flame.cc:98-116). In-flight transfer DEPTH stays
    # capped by topology_lag; a join age above the depth just tolerates
    # more topology staleness. Under frame_batch >= 2, prefer a few
    # batches' worth: with sheds disabled, a join age of one batch forces
    # a blocking join every batch.
    join_age: int = 3
    # Flow-control policy for a stale unlanded head transfer (age >=
    # join_age): up to this many CONSECUTIVE sheds — pop the head, leave
    # its un-cancellable transfer to finish in the background (tracked
    # so the in-flight depth cap stays honest), discard its bytes, and
    # keep dispatching against the cached topology (staleness is
    # masked-inert; the post-stall refresh then comes from a FRESHER
    # snapshot than the pre-stall head). Past the budget a stale head
    # is joined BLOCKING. The bound is on DROPPED TRANSFERS between
    # consumes (it stops slow-but-landing transfers from cycling sheds
    # forever), NOT a wall-clock drift bound: in a full stall the queue
    # empties and update() free-runs on device-only state with a frozen
    # host mirror until the first landing. A successful consume resets
    # the count. Sheds are counted (stats['packed_sheds']) and their
    # poseframes' BA observations noted via stats['ba_obs_dropped_pfs']
    # — never silent. 0 = never shed (always block at join_age).
    max_consecutive_sheds: int = 8
    # Backstop: block for the head transfer when the newest staged
    # topology is older than this many frames.
    max_topology_staleness: int = 5
    # Process N frames per device dispatch at steady state (pipeline
    # .batch_step): update() buffers frame_batch frames and dispatches
    # them as ONE upload + ONE fused jit (a lax.scan of create/track/
    # detect over the batch + sync + smooth + mesh). Per-frame tracking
    # semantics are the exact sequential semantics; smoothing/mesh
    # cadence becomes per-batch and output latency grows by
    # frame_batch-1 frames. Divides the per-dispatch fixed cost (launch,
    # host bookkeeping, transfers) by frame_batch. 1 = classic per-frame
    # path.
    frame_batch: int = 1
    # Deterministic async scheduling: join every in-flight packed
    # transfer and host triangulation at its staging point instead of
    # opportunistically when ready. The async pipeline's adoption
    # cadence otherwise depends on thread wall-clock timing, so two runs
    # from identical state can adopt topologies on different frames
    # (harmless masked staleness, but not reproducible). On for
    # bit-reproducible runs (checkpoint/resume tests, regression
    # debugging); off for production throughput.
    deterministic: bool = False
    # Coalesce host->device uploads: when update() receives a HOST
    # (numpy uint8) image under async_topology, the freshly triangulated
    # topology words ride the next frame's image upload as one combined
    # u8 buffer, split on device — one transfer instead of two, for one
    # extra frame of (masked-inert) topology staleness.
    coalesce_uploads: bool = True


@dataclass(frozen=True)
class BAParams:
    """Windowed bundle adjustment over keyframe poses (new vs reference;
    internalizes the updatePoseFramePoses/prunePoseFrames contract,
    reference flame.h:155-174)."""

    window_size: int = 8  # Number of keyframes in the BA window.
    n_gn_iters: int = 5  # Gauss-Newton iterations per solve.
    damping: float = 1e-4  # Levenberg-Marquardt damping.
    huber_delta: float = 2.0  # Huber robust loss width (pixels).
    obs_capacity: int = 16384  # Fixed observation buffer size.
    max_landmarks: int = 1024  # Landmark slots per solve window.
    max_obs: int = 4096  # Observation rows per solve window.
    # A solve whose final mean weighted residual^2 exceeds this (px^2) is
    # considered diverged/contaminated: nothing is written back.
    max_mean_cost: float = 9.0
    # Stage a new window solve only after this many NEW poseframes since
    # the last staged solve (1 = every new poseframe, the reference-
    # estimator-like cadence). Since solves warm-start from the previous
    # solution, a deployment that cannot spare a solve's device time
    # (rematch + Gauss-Newton) per poseframe raises this — e.g. 4 with
    # window_size=8 still refines every pose twice per window turnover.
    solve_min_new_pfs: int = 1
    # Quadratic prior anchoring each pose to its INPUT odometry value
    # (px^2 per (m|rad)^2): BA refines within the external estimator's
    # uncertainty instead of free-floating on match noise. The anchors
    # are the poses each keyframe ENTERED with (ba/window.py records
    # them from its first snapshot), not the current refined values —
    # anchoring to refined poses lets the sliding window random-walk.
    # Sweep (60-frame exact-pose damage vs 24-frame noisy-pose ATE):
    # 1e4 -> err 0.0076 / ATE 6.8 mm; 1e5 -> 0.0015 / 9.2 mm;
    # 1e6 -> 0.0024 / 11.0 mm. 1e5 bounds the damage good odometry
    # takes (5x less than 1e4) while keeping a 0.67x ATE improvement
    # under 15 mm input noise. 0 disables.
    pose_prior_weight: float = 1e5
    # Unconstrained 2-D re-matching of observations before each solve
    # (ba/rematch.py): epipolar-constrained front-end matches have zero
    # residual perpendicular to the (noisy-pose) epiline by construction,
    # leaving BA nearly blind to pose error. Radius in px; max_cost gates
    # acceptance (SSD over the 5x5 patch, line_stereo-scaled).
    do_rematch: bool = True
    rematch_radius: int = 3
    rematch_max_cost: float = 6500.0
    # KLT corner gate: min eigenvalue of the anchor patch's gradient
    # structure tensor required to trust a 2-D match (aperture problem —
    # edge-like patches keep their epipolar match). Tuning (synthetic
    # noisy-pose A/B, tests/test_evaluation.py): 25 passes real corners
    # while rejecting the near-1-D patches (lambda_min ~0.2) whose
    # ungated re-matching measured 5x ATE inflation. A mid threshold that
    # re-matches only PART of the corner population (e.g. 100 -> 28%)
    # is worse than none — mixed match populations fight each other —
    # so prefer thresholds that are decisive either way.
    rematch_min_eig: float = 25.0
    # Whiten residuals/Jacobians by each anchor patch's structure tensor
    # (ba/rematch.observation_weights): edge features contribute only
    # their gradient-direction constraint. Off by default: for epipolar-
    # matched observations the perpendicular component acts as a
    # stabilizing pseudo-prior toward the input poses, and dropping it
    # measured WORSE on edge-dominated scenes (14-16 vs 6-10 mm ATE);
    # enable for corner-rich imagery with 2-D re-matching.
    aniso_weights: bool = False
    # Skip the refined-IDEPTH write-back when the solve barely moved the
    # window poses (max translation delta below this, meters, AND max
    # rotation delta below writeback_min_drot, radians). BA depths come
    # from rematch correspondences that carry px-level SSD noise; on
    # already-accurate odometry a solve that changes nothing still
    # rewrote converged filter depths with those noisier triangulations
    # (96-frame exact-pose run: median err 0.0026 vs 0.0002 BA-off).
    # Under real pose error the correction exceeds these
    # thresholds and depths re-triangulate as before. Poses ALWAYS
    # apply. Setting BOTH to 0 disables the gate; setting ONE to 0
    # disables that axis only (it always passes the skip test, so the
    # gate decides on the other axis alone). Skips are counted
    # (stats['ba_writeback_skips']), never silent.
    writeback_min_dt: float = 1e-3
    writeback_min_drot: float = 1e-3


@dataclass(frozen=True)
class Params:
    """Top-level parameter struct (reference: params.h:36-143)."""

    # --- Capacities (bound every device array). ---
    feature_capacity: int = 4096  # Max live features == max graph vertices.
    edge_capacity: int = 16384  # Max Delaunay edges (~3V for planar graphs).
    triangle_capacity: int = 12288  # Max Delaunay triangles (~2V).
    poseframe_capacity: int = 32  # Max resident poseframes (keyframes).

    # --- Detection. ---
    min_grad_mag: float = 5.0  # params.h:39
    do_grad_check_after_projection: bool = False  # params.h:42
    detection: DetectionParams = dataclasses.field(default_factory=DetectionParams)
    photo_error_num_pfs: int = 30  # Poseframes considered for cmp-frame scoring.

    # --- Filter / measurement. ---
    zparams: MeasModelParams = dataclasses.field(default_factory=MeasModelParams)
    rescale_factor_min: float = 0.7  # params.h:58-59
    rescale_factor_max: float = 1.4
    idepth_init: float = 0.01  # params.h:60-62
    idepth_var_init: float = 0.25
    idepth_var_max: float = 0.25  # Feature killed above this variance.
    max_dropouts: int = 5  # Feature killed after this many failed tracks.
    outlier_sigma_thresh: float = 3.0  # Chi^2 gate on measurements.
    min_baseline: float = 0.01  # Min baseline to attempt an idepth update.
    do_meas_fusion: bool = True  # If false, posterior = raw measurement.
    fparams: FilterParams = dataclasses.field(default_factory=FilterParams)

    # --- Triangle filters. ---
    tri_filter: TriangleFilterParams = dataclasses.field(
        default_factory=TriangleFilterParams)

    # --- Regularizer. ---
    min_height: float = 0.1  # World-height gate for graph membership (params.h:88-89).
    max_height: float = 4.0
    idepth_var_max_graph: float = 1e-2  # Max feature var to enter the graph.
    adaptive_data_weights: bool = False  # weight = 1/var instead of 1.
    init_with_prediction: bool = False  # Init new vertices from dense map.
    rescale_data: bool = False  # Renormalize graph scale to mean idepth.
    check_sticky_obstacles: bool = False  # Reset x if sucked toward camera.
    do_nltgv2: bool = True
    rparams: RegularizerParams = dataclasses.field(default_factory=RegularizerParams)
    solver: SolverParams = dataclasses.field(default_factory=SolverParams)

    # --- Automatic poseframe selection (new; the reference leaves the
    # is_poseframe decision to its frontend, flame.h:145-147). When
    # enabled and update() is called with is_poseframe=None, a new
    # poseframe is declared once the stereo disparity of a probe pixel
    # vs the current poseframe exceeds auto_pf_max_disparity px (probe
    # at auto_pf_depth meters), or the keyframe score hard-rejects the
    # geometry (keyframe_selector.cc:139-255 semantics). ---
    auto_poseframe: bool = False
    auto_pf_max_disparity: float = 16.0
    auto_pf_depth: float = 5.0

    # --- Bundle adjustment (new). ---
    do_ba: bool = False
    ba: BAParams = dataclasses.field(default_factory=BAParams)

    # --- Debug / observability. ---
    debug_quiet: bool = True
    scene_color_scale: float = 1.0

    # Image dtype on device.
    compute_dtype: str = "float32"

    def replace(self, **kwargs) -> "Params":
        return dataclasses.replace(self, **kwargs)

    @property
    def border(self) -> int:
        """Valid-region border: rescale_factor_max * win/2 + 1 (flame.cc:1576)."""
        return int(self.rescale_factor_max * self.fparams.win_size / 2 + 1)

    @property
    def pad(self) -> int:
        """Image padding width = filter window size (flame.cc:149)."""
        return self.fparams.win_size
