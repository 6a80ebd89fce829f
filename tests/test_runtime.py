"""Process set-up helper (utils/runtime.py): where the compile cache goes."""

import os
import subprocess
import sys

from orbslam_in_practice.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_honours_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, a compiled program is cached
    there (and the helper names no other directory)."""
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "from orbslam_in_practice.utils import runtime\n"
        "print(runtime.setup(cpu=True))\n"
        "import jax, jax.numpy as jnp\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.jit(lambda x: x * 2 + 1)(jnp.arange(7.0)).block_until_ready()\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(cache), str(cache)]
    assert any(cache.iterdir())


def test_cache_defaults_to_checkout(monkeypatch):
    """Without the variable the cache is one fixed path inside the
    checkout, and git ignores it."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
