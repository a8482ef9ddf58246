"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (tests, benchmarks, the smoke check):

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, so nothing is
  set in code.
* unset: a fixed ``.jax_cache`` directory beside the package (the
  repository root, git-ignored).  A fixed path matters because the path
  is part of what a cache hit needs.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

import jax

__all__ = ["compile_cache_dir", "enable_compile_cache"]

ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The cache directory the rule above selects."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV):
        return environ[ENV]
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir` and
    return it.  Programs that compile faster than ``min_compile_secs``
    are not cached."""
    path = compile_cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_compile_secs)
    return path
