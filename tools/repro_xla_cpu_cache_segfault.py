#!/usr/bin/env python
"""Standalone repro for the XLA:CPU executable-serialization segfault
that forces tests/conftest.py's per-module jax.clear_caches() workaround
(pinned as a repro so the workaround does not outlive the bug).

Symptom: with the persistent compilation cache enabled, a single process
that compiles many distinct executables eventually SEGFAULTS inside the
cache-write path (executable serialization), not in user code. Observed
on jax 0.9.x / CPU PJRT: the flame_tpu test suite died deterministically
at a few hundred accumulated executables (always at the same test on a
cold cache; the same test is clean in isolation or after
jax.clear_caches()).

This script compiles N trivially-distinct programs with the persistent
cache on. If the bug is present it dies with SIGSEGV before finishing;
if jax has fixed it, it prints OK — at which point the conftest
workaround (and this file) can be removed.

Usage:
    python tools/repro_xla_cpu_cache_segfault.py [n_programs]
(defaults to 600; run with a COLD cache for a faithful repro:
    rm -rf .jax_cache_repro, or point JAX_COMPILATION_CACHE_DIR at an
    empty directory)
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax
import jax.numpy as jnp

from flame_tpu.utils import compile_cache

jax.config.update("jax_platforms", "cpu")
compile_cache.enable(".jax_cache_repro")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 600
    print(f"jax {jax.__version__}, backend {jax.default_backend()}; "
          f"compiling {n} distinct executables...")
    x = jnp.arange(1024, dtype=jnp.float32)
    for i in range(n):
        # Distinct constant -> distinct program -> fresh compile + cache
        # write. Mix a few op shapes so the executables are not all
        # byte-size twins.
        if i % 3 == 0:
            f = jax.jit(lambda v, k=float(i): jnp.sin(v * k).sum())
        elif i % 3 == 1:
            f = jax.jit(lambda v, k=i: jnp.roll(v, k) @ v)
        else:
            f = jax.jit(lambda v, k=i: jnp.cumsum(v + k)[::7].mean())
        float(f(x))
        if (i + 1) % 50 == 0:
            print(f"  {i + 1} compiled ok", flush=True)
    print("OK — no segfault at this count; the conftest per-module "
          "clear_caches() workaround may be removable (try the full "
          "suite without it).")


if __name__ == "__main__":
    main()
