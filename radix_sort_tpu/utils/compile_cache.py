"""Persistent compilation cache location.

A cache entry's key includes its directory, so the directory must not move
between runs. ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it
itself and nothing else is configured here. Otherwise the cache lives at
the fixed path ``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Call before the first compile."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
