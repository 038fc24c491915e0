"""Test harness setup (SURVEY.md §5).

Tests run on CPU with 8 virtual devices (the standard JAX trick for testing
shard_map logic without a multi-device machine) and with x64 enabled so
f64 oracles are exact. Library code is dtype-explicit, so enabling x64 here
does not change the f32 fast paths under test. The config flip below makes
a plain ``pytest`` run the CPU suite even on a machine with a GPU; the
usual invocation also sets ``JAX_PLATFORMS=cpu``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", jax.devices()
assert len(jax.devices()) == 8, jax.devices()


import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "quick: fast core-math/solver/data tier for per-commit runs "
        "(`pytest -m quick`, <90 s on this box); the full sweep stays the "
        "round-end gate")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The full suite compiles ~100 distinct XLA programs in one process; with
    everything retained, the XLA CPU compiler deterministically aborts
    around the ~70th compilation (reproduced twice at the same test, while
    the same file passes in a fresh process). Dropping executable caches at
    module boundaries keeps the process inside whatever compiler resource
    limit is being hit, at the cost of re-tracing shared helpers.
    """
    yield
    jax.clear_caches()
