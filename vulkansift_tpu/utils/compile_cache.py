"""Persistent XLA compilation cache location.

Entry points (``chip_smoke.py``, ``bench.py``, the perf CLIs) call
:func:`enable_compile_cache` once at start-up; importing the library never
touches the cache. If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
reads it and nothing else is configured. Otherwise the cache lives at one
fixed path inside the checkout (``.jax_cache/``, git-ignored): the path is
part of what makes a later run find the entries, so it never contains a
temporary name, a pid or a timestamp.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = REPO_ROOT / ".jax_cache"


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The cache directory the process should use: the environment
    variable when set (and non-empty), else the fixed in-checkout path."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
