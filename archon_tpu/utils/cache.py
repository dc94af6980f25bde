"""Placement of JAX's persistent compilation cache.

Every entry point (the CLI, ``bench.py``, ``chip_smoke.py`` and the
``scripts/``) calls :func:`enable_compile_cache` before its first compile, so
all of them share one cache.  The path is part of the cache key, so it must
not move between runs: ``$JAX_COMPILATION_CACHE_DIR`` when it is set, else
the fixed ``<repo>/.jax_cache`` (git-ignored).

A process that has switched the cache off (``JAX_ENABLE_COMPILATION_CACHE=false``,
as the test suite does: XLA:CPU's executable serialisation crashes on its
largest programs) keeps it off.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=os.environ) -> str:
    """The cache directory: the environment's choice, else the repo's."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable_compile_cache() -> str | None:
    """Point JAX's persistent cache at :func:`cache_dir`; returns the path,
    or None when the process has the cache switched off."""
    import jax

    if not jax.config.jax_enable_compilation_cache:
        return None
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
