"""Process set-up shared by every entry point: the persistent compilation
cache and, for tests and CPU runs, the platform.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set, and
otherwise at one fixed path inside the checkout (``<repo>/.jax_cache``,
listed in ``.gitignore``): the directory is part of the cache key, so a
path that moves between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def cache_dir() -> str:
    """The compilation-cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def setup(cpu: bool = False) -> str:
    """Configure JAX for this process; call before its first computation.

    cpu=True holds the process to the CPU backend. Returns the cache
    directory.
    """
    if cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
