"""JAX's persistent compilation cache, at one fixed place.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads the directory from it
and nothing here overrides it. Otherwise the cache lives in a fixed
directory of the checkout (`.jax_cache/` by default): the path is part of
the cache key, so a directory that moves between runs never hits.
"""

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(name: str = ".jax_cache") -> str:
    """The directory enable(name) makes JAX use."""
    return os.environ.get(ENV_VAR) or os.path.join(REPO_ROOT, name)


def enable(name: str = ".jax_cache") -> str:
    """Turn the persistent cache on for every compiled program; returns
    its directory."""
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", cache_dir(name))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir(name)
