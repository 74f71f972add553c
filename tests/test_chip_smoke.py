"""chip_smoke.py's helpers: the GPU check, the nvidia-smi parser, the last
line's keys, and the compile-cache placement it shares with bench.py and
the tests."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import chip_smoke
from flame_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dev(platform, kind):
    return SimpleNamespace(platform=platform, device_kind=kind)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu([dev("cpu", "cpu")])


def test_require_gpu_counts_cards():
    gpus = [dev("gpu", "NVIDIA H100 80GB HBM3")]
    chip_smoke.require_gpu(gpus)
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.require_gpu(gpus, 4)


def test_exits_nonzero_without_gpu():
    """Under JAX_PLATFORMS=cpu the script fails and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_result_line_keys():
    devs = [dev("gpu", "NVIDIA H100 80GB HBM3")] * 4
    line = chip_smoke.result_line(devs)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.parametrize("text,cards", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n",
     [("NVIDIA H100 80GB HBM3", "500.00 W")] * 2),
])
def test_parse_smi(text, cards):
    assert chip_smoke.parse_smi(text) == cards


def test_parse_smi_rejects_empty():
    with pytest.raises(ValueError):
        chip_smoke.parse_smi("\n")


def _recorded_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_cache_dir_from_env_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _recorded_updates(monkeypatch)
    assert compile_cache.enable() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_cache_dir_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _recorded_updates(monkeypatch)
    first = compile_cache.enable()
    assert first == os.path.join(ROOT, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == first
    assert compile_cache.enable() == first  # no temp name, pid or time
    assert compile_cache.enable(".jax_cache_cpu") == os.path.join(
        ROOT, ".jax_cache_cpu")
