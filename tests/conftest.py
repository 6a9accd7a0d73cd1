"""Test configuration: a virtual 8-device CPU backend, and the `gpu` marker.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`). `--xla_force_host_platform_
device_count=8` is injected before the first backend discovery so sharded
tests can build 8-device meshes from `jax.devices("cpu")` — the standard JAX
multi-device simulation (SURVEY.md §4).

Tests that need an NVIDIA GPU carry the `gpu` marker and take the
`gpu_device` fixture, which decides at run time — never at import — whether
a card is present and skips otherwise. On the card, chip_smoke.py runs them.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (run by chip_smoke.py)")


@pytest.fixture
def gpu_device():
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    return devices[0]
