"""Persistent XLA compilation cache — the warm-start path.

The reference launches and renders immediately (its pipelines are built from
pre-compiled SPIR-V at startup, `src/raytracer/raytracing_renderer.odin`);
the analog here is JAX's persistent compilation cache: the first process
pays the XLA compile of the frame program, later processes load it.

Where the cache lives:
  - `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself, and this module
    sets no directory in code.
  - otherwise: one fixed directory inside the checkout, `<repo>/.jax_cache`
    (git-ignored). A fixed path matters because the path is part of the
    cache key; a directory that moves never hits.

Call `enable_persistent_cache()` once per process before the first jit
execution (cli.py and bench.py do). Safe to call twice.
"""

from __future__ import annotations

import logging
import os

DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

_log = logging.getLogger(__name__)


def cache_dir() -> str:
    """The directory the persistent cache uses in this process."""
    return os.environ.get(ENV_VAR) or DEFAULT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Turn on the persistent compilation cache and drop the size/time
    thresholds so the frame program is always cached. Returns the dir."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything: the frame programs are few and large, and even the
    # small helper jits recompile on every process start otherwise.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    _log.info("persistent XLA compilation cache at %s", path)
    return path
