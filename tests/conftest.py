"""Test configuration: the suite runs on an 8-device virtual CPU platform.

Multi-device sharding paths run on a host-CPU mesh via
``--xla_force_host_platform_device_count``, no GPU required. The platform
is set through jax.config before any backend is initialized.

Tests marked ``gpu`` need the card: they take the ``gpu`` fixture, which
skips them on the CPU. ``chip_smoke.py`` runs them on the GPU with
``MLX_MCMC_TEST_GPU=1``, which leaves JAX on its default platform.
"""

import os

import pytest

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

if os.environ.get("MLX_MCMC_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)


@pytest.fixture
def gpu():
    """The first GPU. Decided here, when the test runs: skips on the CPU."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs it on the card")
    return device
