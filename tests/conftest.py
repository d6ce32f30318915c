"""Test configuration.

The suite runs on JAX's CPU backend with eight virtual devices, so the
multi-device sharding paths are exercised without accelerators.  Tests
marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on a GPU host run
them with ``PTPU_TEST_GPU=1 python -m pytest tests/ -m gpu``, which leaves
JAX on its default (GPU) backend.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("PTPU_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU, decided when the test runs; skips without one."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (PTPU_TEST_GPU=1 on a GPU host)")
    return devices[0]
