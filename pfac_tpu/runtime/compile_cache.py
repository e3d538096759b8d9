"""Where the persistent XLA compile cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache is a fixed directory in the checkout,
``<checkout>/.jax_cache`` (git-ignored): the path is part of the cache
key, so it must not move between runs.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
