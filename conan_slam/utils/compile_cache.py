"""Where JAX keeps its persistent compilation cache.

A cache entry is found again only when the cache sits at the same path, so
every entry point calls ``setup_compile_cache`` before it compiles anything.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# One fixed directory inside the checkout, resolved from the package location
# (listed in .gitignore).
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return it.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to ``DEFAULT_DIR``.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
