"""Test configuration: eight virtual CPU devices, the compile cache, and
double precision where tests pass f64 inputs.

Run the suite on the CPU with `JAX_PLATFORMS=cpu`. Tests that need an NVIDIA
GPU carry the `gpu` marker and decide inside a fixture whether a card is
present, so every worker collects the same tests.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

from ms_slam.utils.runtime import setup_compile_cache  # noqa: E402

setup_compile_cache()
# Tests validate math in double precision where they pass f64 inputs; the
# library is dtype-polymorphic and the pipeline runs f32/bf16.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules. A full-suite run
    accumulates hundreds of CPU executables in one process, and the XLA CPU
    compiler has crashed under that load on small hosts; the persistent
    compilation cache makes re-compiles cheap."""
    yield
    jax.clear_caches()
