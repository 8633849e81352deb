"""Persistent XLA compilation cache.

Every distinct program shape compiles once per machine instead of once
per process.  When JAX_COMPILATION_CACHE_DIR is set, JAX already reads
it and nothing here overrides it.  Otherwise the cache lives at
<checkout>/.jax_cache (listed in .gitignore): a fixed path, because the
path is part of the cache key, and one inside the checkout, so the
program writes nothing around it.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """Where the persistent cache lives for this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
