"""Test configuration.

By default the tests run on the CPU backend with 8 virtual devices, so
multi-device sharding paths are exercised without hardware, and Pallas
kernels run in interpret mode. The environment must be set before JAX
is imported.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them unless the session runs on a GPU:

    LOOPS_PLATFORM=gpu python -m pytest -m gpu tests/
"""
import os

import pytest

if os.environ.get("LOOPS_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when the session has none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with LOOPS_PLATFORM=gpu on the card")
    return jax.devices()[0]
