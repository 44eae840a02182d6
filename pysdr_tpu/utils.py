"""Small host-side helpers shared by the app, bench and chip smoke run."""

from __future__ import annotations

import os

# The persistent compile cache's fixed in-checkout home. The path is part
# of every cache key, so it must stay put from run to run.
DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads that directory
    and nothing is set here; otherwise the cache lives at
    DEFAULT_CACHE_DIR. Call before the first compile.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
