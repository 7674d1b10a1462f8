"""Entry-point set-up: the compile-cache directory, the GPU requirement,
and the trace reduction the kernel profile uses."""
import os
import subprocess
import sys

import jax
import pytest

from ms_slam.utils import runtime


def test_compile_cache_follows_env_var(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from ms_slam.utils.runtime import setup_compile_cache\n"
        "d = setup_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 2 + 1)(jnp.ones(3)).block_until_ready()\n"
        "print(d)\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=runtime.REPO_ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
    assert any(tmp_path.iterdir()), "no compiled entry in the cache dir"


def test_compile_cache_defaults_into_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        d = runtime.setup_compile_cache()
        assert d == os.path.join(runtime.REPO_ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="platform 'cpu'"):
        runtime.require_gpu()


def test_busy_ns_is_interval_union():
    from benchmarks.kernel_profile import busy_ns
    assert busy_ns([]) == 0
    assert busy_ns([(0, 10), (5, 20), (30, 40), (32, 35)]) == 30
    assert busy_ns([(30, 40), (0, 10)]) == 20
