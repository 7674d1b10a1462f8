"""Process set-up shared by every entry point: where compiled programs are
cached, and the device checks a measurement script makes before it prints
a number."""
from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at JAX_COMPILATION_CACHE_DIR
    when that is set, else at a fixed directory inside the checkout (the
    path is part of the cache key, so it must not move between runs).
    Returns the directory in use."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir


def require_gpu():
    """The first JAX device, which must be an NVIDIA GPU: measurement paths
    never fall back to another platform."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"this entry point needs an NVIDIA GPU, but JAX's first device "
            f"is on platform {dev.platform!r} ({dev.device_kind})")
    return dev


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, read
    by a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_banner() -> list[str]:
    """Lines naming the device every following number was measured on."""
    dev = require_gpu()
    return [f"device_kind={dev.device_kind} platform={dev.platform} "
            f"count={len(jax.devices())} jax={jax.__version__}",
            f"nvidia-smi: {gpu_name_and_power_limit()}"]
