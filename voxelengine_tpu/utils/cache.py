"""Persistent compilation cache setup.

Compiling the traversal kernel and the frame programs takes seconds to
minutes per process; the JAX persistent compilation cache makes repeat runs
(bench, apps, chip_smoke) pay that once.  Where ``JAX_COMPILATION_CACHE_DIR``
is set, JAX reads it itself and this module sets no other directory;
otherwise the cache lives at the fixed ``<repo>/.jax_cache`` (a fixed path,
because the directory is part of what a cached entry is found by).
"""

from __future__ import annotations

import os

#: the cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not set
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
