"""Small shared helpers."""

import os
from pathlib import Path

# The checkout's root (the directory holding the nerf_rs_tpu package).
REPO_ROOT = Path(__file__).resolve().parents[2]


def round_up(v: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``v``."""
    return -(-v // m) * m


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``$JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it, and
    nothing else is set here. Otherwise the cache lives at a fixed path
    inside the checkout (``<repo>/.jax_cache``, git-ignored): the path is
    part of the cache key, so a directory that moves never hits."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
