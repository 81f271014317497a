"""Compile-cache placement and the GPU guards of the command-line entries.

Each check runs a fresh Python process: the cache directory and the JAX
platform are fixed when a process first initialises JAX.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILE = """
import jax, jax.numpy as jnp
from voxelengine_tpu.utils.cache import enable_compilation_cache
print(enable_compilation_cache())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
print(float(jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((16, 16))).sum()))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "BENCH_ALLOW_CPU")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.update(extra)
    return env


def _run(args, env, cwd, timeout=300):
    return subprocess.run(args, env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def test_cache_uses_jax_compilation_cache_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled entries land there and
    the module sets no directory of its own."""
    cache = tmp_path / "cc"
    p = _run([sys.executable, "-c", _COMPILE],
             _env(JAX_COMPILATION_CACHE_DIR=str(cache)), cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    assert p.stdout.splitlines()[0] == str(cache)
    assert any(cache.iterdir())
    assert not (tmp_path / ".jax_cache").exists()


def test_cache_default_is_fixed_at_repo_root(tmp_path):
    """Without the variable the directory is <repo>/.jax_cache, whatever
    the working directory."""
    code = ("from voxelengine_tpu.utils.cache import cache_dir, "
            "DEFAULT_CACHE_DIR; print(cache_dir()); print(DEFAULT_CACHE_DIR)")
    p = _run([sys.executable, "-c", code], _env(), cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert p.stdout.split() == [want, want]


def test_cache_entries_land_in_repo_cache(tmp_path):
    """Compiled entries appear under <repo>/.jax_cache when the variable is
    unset."""
    import random

    cache = os.path.join(REPO, ".jax_cache")
    before = set(os.listdir(cache)) if os.path.isdir(cache) else set()
    # a program never compiled before: its entry must be new
    code = _COMPILE.replace("jnp.sin(x)", f"jnp.cos(x) * {random.random()!r}")
    p = _run([sys.executable, "-c", code], _env(), cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    assert p.stdout.splitlines()[0] == cache
    assert set(os.listdir(cache)) - before
    assert not (tmp_path / ".jax_cache").exists()


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_refuses_to_run_without_a_gpu(tmp_path, script):
    """bench.py without BENCH_ALLOW_CPU and chip_smoke.py always exit
    non-zero on a machine whose JAX backend is not a GPU, and print no
    result line."""
    p = _run([sys.executable, os.path.join(REPO, script)], _env(),
             cwd=tmp_path, timeout=600)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
