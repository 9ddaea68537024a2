"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device shardings are validated without a multi-card host via
``--xla_force_host_platform_device_count`` (SURVEY.md §4 implication (c)).
Unless ``JAX_PLATFORMS`` names the platforms, the suite pins the CPU even
where JAX would otherwise pick a GPU; ``jax.config.update`` works after
import as long as no backend has been initialized yet.

Tests that need an NVIDIA card carry the ``gpu`` marker and skip where
JAX has no GPU (the ``gpu_device`` fixture decides).  On a machine with
a card they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

from libre import backend  # noqa: E402

# Persistent compilation cache: the suite is dominated by XLA:CPU compiles
# of scan-heavy render graphs; caching makes re-runs minutes faster.
backend.setup_compile_cache()


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (skipped on the CPU)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu pytest -m gpu")
    return devices[0]
