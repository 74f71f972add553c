"""Dataset-scale accuracy regression on the deterministic mini-TUM
sequence (flame_tpu/io/synthetic.py): dense depth error against ray-cast
ground truth through the real TUM loader path, and ATE of BA-refined
poses vs noisy input poses (BASELINE.md rows 3-4).
Recorded reference numbers live in DATASETS.md."""

import numpy as np
import pytest

from flame_tpu.core.flame import Flame
from flame_tpu.geometry import camera
from flame_tpu.io import datasets, synthetic
from flame_tpu.params import Params, BAParams, DetectionParams, SolverParams
from flame_tpu.utils import evaluation

N_FRAMES = 24
W, H = 256, 192
FX = 210.0


def make_params(do_ba=False):
    return Params(
        feature_capacity=1024, edge_capacity=4096, triangle_capacity=2048,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.2, idepth_var_init=0.25,
        detection=DetectionParams(win_size=12),
        solver=SolverParams(n_iters_per_frame=40, max_vertex_degree=16),
        do_ba=do_ba, ba=BAParams(window_size=6),
        debug_quiet=True)


def run_tum(root, poses=None, do_ba=False):
    frames = datasets.load_tum(root, max_frames=N_FRAMES)
    assert len(frames) == N_FRAMES
    if poses is not None:  # substitute (e.g. noisy) input poses
        for fr, (q, t) in zip(frames, poses):
            fr.q = np.asarray(q, np.float32)
            fr.t = np.asarray(t, np.float32)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = Flame(W, H, K, camera.inv_k(K), make_params(do_ba))
    datasets.run_sequence(fl, frames, poseframe_every=2)
    return fl


def pf_poses(fl):
    ids = sorted(fl._pf_slot_by_id)
    qs, ts = [], []
    for fid in ids:
        s = fl._pf_slot_by_id[fid]
        qs.append(np.asarray(fl._stack.q[s]))
        ts.append(np.asarray(fl._stack.t[s]))
    return ids, np.asarray(qs), np.asarray(ts)


@pytest.fixture(scope="module")
def mini_tum(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini_tum"))
    meta = synthetic.generate_mini_tum(
        root, n_frames=N_FRAMES, width=W, height=H, fx=FX,
        pose_noise_t=0.015, pose_noise_deg=0.3, noise_seed=1)
    return root, meta


def test_depth_accuracy_true_poses(mini_tum):
    root, meta = mini_tum
    fl = run_tum(root)  # ground-truth poses from groundtruth.txt
    q, t = synthetic.trajectory(N_FRAMES - 1)
    K = np.asarray(fl.K, np.float64)
    _, gt_idepth = synthetic.render_frame(K, q, t, W, H)
    stats = evaluation.depth_error_stats(fl.get_inverse_depth_map(),
                                         gt_idepth)
    # Recorded in DATASETS.md; bounds are ~2x the measured values.
    assert stats["coverage"] > 0.35, stats
    assert stats["median_rel"] < 0.04, stats


def test_ba_reduces_ate_on_noisy_poses(mini_tum):
    root, meta = mini_tum
    noisy = meta["noisy"]
    gt = meta["gt"]

    fl_noisy = run_tum(root, poses=noisy, do_ba=False)
    ids_n, _, t_n = pf_poses(fl_noisy)
    gt_t = np.asarray([gt[i][1] for i in ids_n])
    ate_noisy = evaluation.ate_rmse(t_n, gt_t)

    fl_ba = run_tum(root, poses=noisy, do_ba=True)
    ids_b, _, t_b = pf_poses(fl_ba)
    assert ids_b == ids_n
    ate_ba = evaluation.ate_rmse(t_b, gt_t)

    # Without BA the input noise passes straight through (flame does not
    # estimate poses); BA must recover a meaningfully better trajectory.
    assert ate_noisy > 0.005, ate_noisy  # the noise is actually there
    assert ate_ba < 0.8 * ate_noisy, (ate_ba, ate_noisy)


def test_ba_on_exact_poses_keeps_depth_quality(mini_tum):
    """BA on already-accurate odometry must not damage the dense map:
    the write-back innovation gate (BAParams.writeback_min_dt) skips
    rewriting converged filter depths when a solve barely moves the
    poses (pre-gate measurement: median err 0.0026 vs 0.0002 BA-off on
    an exact-pose run)."""
    root, meta = mini_tum
    fl_off = run_tum(root, do_ba=False)
    fl_ba = run_tum(root, do_ba=True)  # ground-truth poses
    q, t = synthetic.trajectory(N_FRAMES - 1)
    K = np.asarray(fl_off.K, np.float64)
    _, gt_idepth = synthetic.render_frame(K, q, t, W, H)
    s_off = evaluation.depth_error_stats(fl_off.get_inverse_depth_map(),
                                         gt_idepth)
    s_ba = evaluation.depth_error_stats(fl_ba.get_inverse_depth_map(),
                                        gt_idepth)
    # The gate must actually fire on exact poses...
    assert fl_ba.stats.snapshot()["stats"].get("ba_writeback_skips", 0) > 0
    # ...and the map must stay within 1.5x of the BA-off quality.
    assert s_ba["median_rel"] < max(1.5 * s_off["median_rel"], 0.005), \
        (s_ba, s_off)


def test_depth_quality_degrades_gracefully_with_noise(mini_tum):
    """Noisy poses must not collapse the dense map (robustness gates)."""
    root, meta = mini_tum
    fl = run_tum(root, poses=meta["noisy"], do_ba=False)
    q, t = synthetic.trajectory(N_FRAMES - 1)
    K = np.asarray(fl.K, np.float64)
    _, gt_idepth = synthetic.render_frame(K, q, t, W, H)
    # Evaluate against truth at the TRUE final pose; the estimated map is
    # in the noisy frame, so allow a loose bound — this is a sanity floor.
    stats = evaluation.depth_error_stats(fl.get_inverse_depth_map(),
                                         gt_idepth)
    assert stats["coverage"] > 0.2, stats
    assert stats["median_rel"] < 0.2, stats
