"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it by itself and this
module sets nothing. Otherwise the cache lives at a fixed path inside the
checkout (``<repo>/.jax_cache``, git-ignored): the path is part of the
cache's key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO, ".jax_cache")


def enable_compilation_cache() -> Optional[str]:
    """Turn the persistent cache on; returns the directory set in code, or
    None when the environment variable already names one."""
    if os.environ.get(ENV_VAR):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
