"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (``chip_smoke.py``, ``bench.py``,
``bench_all.py``, ``programs/*.py``): when ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX reads it itself and nothing is set in code; otherwise the cache
lives at a fixed directory inside the checkout (listed in ``.gitignore``).
The path is part of what a cache entry is found by, so a directory that
moved between runs would never hit.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Call before the first compilation of the process."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
