"""Every f32 matrix product on the device path asks for full precision.

A GPU may run a float32 dot_general in TF32 (about three decimal digits)
unless the product carries Precision.HIGHEST. The pipeline's geometry
(KRK^-1 chains, keyframe scoring, BA whitening and normal equations) is
sensitive to that rounding, so this reads the jaxprs of the three device
entry points — batch_step, post_delaunay_step and the BA window solve —
as traced by a short BA-on run, and checks every dot_general in them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flame_tpu.ba import window
from flame_tpu.core import pipeline
from flame_tpu.core.flame import Flame
from flame_tpu.geometry import se3, camera
from flame_tpu.params import (Params, BAParams, DetectionParams,
                              SolverParams)

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0

ENTRY_POINTS = {
    "batch_step": (pipeline, "batch_step"),
    "post_delaunay_step": (pipeline, "post_delaunay_step"),
    "ba_window_solve": (window, "_solve_packed"),
}


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    img = (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
           + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def traced():
    """First call of each entry point during a short BA-on batched run,
    traced to its jaxpr."""
    calls = {}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            calls.setdefault(name, (fn, args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    params = Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16), do_ba=True,
        ba=BAParams(window_size=4, n_gn_iters=2, obs_capacity=4096,
                    max_landmarks=256, max_obs=1024,
                    aniso_weights=True),
        solver=SolverParams(n_iters_per_frame=10, max_vertex_degree=16,
                            async_topology=True, frame_batch=2,
                            deterministic=True),
        debug_quiet=True)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    with pytest.MonkeyPatch.context() as mp:
        for name, (mod, attr) in ENTRY_POINTS.items():
            mp.setattr(mod, attr, recorder(name, getattr(mod, attr)))
        fl = Flame(W, H, K, camera.inv_k(K), params)
        for i in range(16):
            fl.update(i * 0.1, i, (se3.quat_identity(),
                                   jnp.array([0.15 * i, 0.0, 0.0])),
                      render(0.15 * i), i % 2 == 0)
        fl.get_inverse_depth_map()
    return {name: fn.trace(*args, **kwargs).jaxpr
            for name, (fn, args, kwargs) in calls.items()}


def _dot_precisions(jaxpr):
    """precision params of every dot_general, sub-jaxprs included."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(getattr(jaxpr, "jaxpr", jaxpr))
    return out


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_every_dot_is_highest(traced, name):
    assert name in traced, f"{name} never ran in the traced sequence"
    precs = _dot_precisions(traced[name])
    assert precs, f"{name}: no dot_general found"
    hi = jax.lax.Precision.HIGHEST
    low = [p for p in precs
           if p is None or any(x != hi for x in p)]
    assert not low, f"{name}: {len(low)}/{len(precs)} dots below HIGHEST"
