"""Test configuration: an 8-device CPU platform, set before JAX initializes.

The tests run on the CPU backend with 8 virtual devices, so the
multi-device sharding paths compile and execute without accelerators.
Tests that need a GPU carry the `gpu` marker and skip here (the `gpu`
fixture below decides at run time); `python chip_smoke.py` runs the
program itself on the card.
"""

import os
import sys

# The repo root (bench.py, chip_smoke.py, __graft_entry__.py) is importable.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# FLAME_TESTS_ON_GPU=1 leaves the platform choice to JAX, so that the
# `gpu`-marked tests reach the card: FLAME_TESTS_ON_GPU=1 python -m pytest
# -m gpu tests/. Otherwise the CPU is forced before jax initializes.
ON_GPU = os.environ.get("FLAME_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

from flame_tpu.utils import compile_cache

# Persistent compilation cache, kept apart from the GPU runs' .jax_cache
# (a concurrent CPU + GPU pair writing one cache dir has aborted inside
# jax's cache writer).
compile_cache.enable(".jax_cache_cpu")

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Cap in-process executable accumulation at one module's worth.

    With the whole suite in one process, XLA CPU's executable
    serialization (persistent-cache write) segfaults deterministically
    once a few hundred compiled programs have accumulated (observed at
    tests/test_keyframe_cmp.py on a cold cache; the same test is clean in
    isolation or after any shorter prefix). Dropping the in-memory jit
    cache between modules keeps the process below the trigger point;
    recompiles land on the persistent disk cache, so warm-run cost is
    deserialization only.
    """
    yield
    import jax
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(scope="session")
def gpu():
    """The first GPU, or a skip when this process has none (decided at
    run time, so every worker collects the same tests)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: FLAME_TESTS_ON_GPU=1 python -m pytest "
                    "-m gpu tests/")
    return devs[0]
