"""Small runtime utilities."""

from __future__ import annotations

import os

_CACHE_ENABLED = False

#: Compile-cache directory when JAX_COMPILATION_CACHE_DIR is unset: fixed
#: at the checkout root, because the path is part of each entry's key.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Compiling the fused encode program takes seconds per geometry; the
    persistent cache makes every geometry a one-time cost across
    processes.  JAX reads JAX_COMPILATION_CACHE_DIR itself, so when it is
    set no other path is set here; otherwise the cache lives at
    DEFAULT_CACHE_DIR.  Idempotent.
    """
    global _CACHE_ENABLED
    import jax

    if not _CACHE_ENABLED:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _CACHE_ENABLED = True
    return jax.config.jax_compilation_cache_dir
