"""GPU against CPU, stage by stage (flame_tpu.utils.device_parity), from
the state of a short run of the bench scene on the card. These skip
without a GPU; chip_smoke.py runs the same checks at the real widths.

    FLAME_TESTS_ON_GPU=1 python -m pytest -m gpu tests/
"""

import jax
import pytest

import bench
import chip_smoke
from flame_tpu.core.flame import Flame
from flame_tpu.utils import device_parity as dp

pytestmark = pytest.mark.gpu

W, H, N_FEATS, N_FRAMES = 320, 240, 1024, 24


@pytest.fixture(scope="module")
def run(gpu):
    """(flame, gpu, cpu) after N_FRAMES resident frames on the GPU."""
    K, Kinv = bench.intrinsics(W, H)
    with jax.default_device(gpu):
        fl = Flame(W, H, K, Kinv, bench.make_params(False, N_FEATS))
        chip_smoke.drive(fl, N_FRAMES, True, W, H, gpu)
    return fl, gpu, jax.devices("cpu")[0]


def test_smoother_matches_cpu(run):
    fl, dev, cpu = run
    r = dp.smoother(fl.params.rparams, fl._graph,
                    fl.params.solver.n_iters_per_frame, dev, cpu)
    assert r["ok"], r


def test_batched_rasterizer_matches_bruteforce_on_cpu(run):
    fl, dev, cpu = run
    views = chip_smoke.raster_views(fl, N_FRAMES,
                                    fl.params.solver.frame_batch)
    r = dp.raster(*views, H, W, dev, cpu)
    assert r["ok"], r


def test_tracking_matches_cpu(run):
    fl, dev, cpu = run
    q, t = bench.pose(N_FRAMES)
    img = bench.render(W, H, bench.STEP_X * N_FRAMES)
    r = dp.tracking(fl.params, fl.K, fl.Kinv, fl._stack, fl._feats,
                    (N_FRAMES, q, t, img), fl._curr_pf_slot, dev, cpu)
    assert r["ok"], r
