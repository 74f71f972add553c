"""resolve_smoother: "auto" runs the XLA vertex smoother on every backend,
an explicit "vertex" or "halo" is honoured, "halo" needs a device mesh,
and modes the package does not implement fail loudly at construction."""

import pytest

from flame_tpu.core import pipeline
from flame_tpu.params import Params, SolverParams


def params_with(smoother):
    return Params(solver=SolverParams(max_vertex_degree=20,
                                      smoother=smoother))


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_auto_is_vertex(monkeypatch, backend):
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert pipeline.resolve_smoother(params_with("auto")) == "vertex"


def test_vertex_is_honoured():
    assert pipeline.resolve_smoother(params_with("vertex")) == "vertex"


def test_halo_with_mesh_is_honoured():
    from flame_tpu.parallel import sharding
    import jax
    mesh = sharding.make_mesh(jax.devices()[:2])
    assert pipeline.resolve_smoother(params_with("halo"), mesh) == "halo"


def test_halo_without_mesh_raises():
    with pytest.raises(ValueError, match="mesh"):
        pipeline.resolve_smoother(params_with("halo"))


@pytest.mark.parametrize("mode", ["pallas", "pallas_halo"])
def test_removed_modes_raise(mode):
    with pytest.raises(ValueError) as ei:
        pipeline.resolve_smoother(params_with(mode))
    msg = str(ei.value)
    for valid in pipeline.SMOOTHERS:
        assert valid in msg


def test_flame_rejects_unknown_mode():
    from flame_tpu.core.flame import Flame
    from flame_tpu.geometry import camera
    K = camera.make_k(100.0, 100.0, 32.0, 24.0)
    with pytest.raises(ValueError, match="valid modes"):
        Flame(64, 48, K, camera.inv_k(K),
              params_with("pallas").replace(feature_capacity=64,
                                            edge_capacity=192,
                                            triangle_capacity=128))
