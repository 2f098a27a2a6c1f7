"""Where the persistent XLA compilation cache lives.

One rule for every entry point (tests, ``chip_smoke.py``, ``bench.py``, the
multi-process fleet workers): ``JAX_COMPILATION_CACHE_DIR`` when it is set,
otherwise the fixed in-repo directory ``<repo>/.jax_cache``. The path is part
of the cache key, so it never depends on a temporary directory, a pid or a
time.
"""
from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` or ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def enable_compile_cache(min_compile_time_s: float = 0.5) -> str:
    """Point this process's JAX at :func:`compile_cache_dir` and return it.

    Call before the first compilation. Programs that compile in under
    ``min_compile_time_s`` are not written to the cache."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_time_s)
    return path


def compile_cache_env(env: dict, min_compile_time_s: float = 0.5) -> dict:
    """``env`` plus the variables that give a child JAX process the same cache."""
    out = dict(env)
    out["JAX_COMPILATION_CACHE_DIR"] = compile_cache_dir()
    out["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = str(min_compile_time_s)
    return out
