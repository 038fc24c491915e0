"""Device settings shared by the entry points and the library: the compile
cache, the precision of f32 contractions, and the card's identity.

Compile cache rule: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and :func:`enable_compile_cache` sets nothing. Otherwise the cache is
the fixed directory ``<checkout>/.jax_cache`` (listed in ``.gitignore``). A
fixed path matters: the path is part of the cache key, so a directory that
moves never hits.
"""

from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["CACHE_ENV", "MATMUL_PRECISION", "default_cache_dir",
           "enable_compile_cache", "gpu_name_and_power_limit"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

# Precision of the f32 contractions in the pose-graph solvers and the small
# matcher/closure/ATE einsums. On the GPU an f32 dot without it may run in
# TF32, which keeps about three significant digits: that left the 10k-pose
# supernodal solve 1-2% higher in chi^2, varying from run to run (PERF.md).
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: the cache used when the env var is unset."""
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(checkout, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> list[str]:
    """One ``"<name>, <power limit>"`` line per card, as ``nvidia-smi``
    reports them. Raises when ``nvidia-smi`` is absent or fails: a number
    recorded without the card's power limit cannot be compared."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]
