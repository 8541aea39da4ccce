"""Where JAX keeps its persistent compilation cache for this repository.

Large fused step programs take tens of seconds to compile; the persistent
cache lets later processes reuse them. The cache's path is part of its key,
so it lives at one fixed place.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here; otherwise the cache goes to `<repo>/.jax_cache`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
