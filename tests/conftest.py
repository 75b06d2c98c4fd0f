"""Test harness config: CPU backend with 8 virtual devices (the standard
fake-backend trick for exercising shard_map/collectives without a GPU) and
x64 enabled so the full 64-bit type matrix is testable.

``RST_TEST_PLATFORMS`` (default ``cpu``) is the JAX platform list the tests
run with. ``RST_TEST_PLATFORMS=cpu,cuda python -m pytest tests/ -m gpu``
keeps the CPU as the default backend and makes a GPU visible to the tests
marked ``gpu``; whether a card is present is decided inside the
``gpu_device`` fixture, never at import.
"""

import os

_platforms = os.environ.get("RST_TEST_PLATFORMS", "cpu")
os.environ["JAX_PLATFORMS"] = _platforms
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", _platforms)
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

# test tiers: `-m "not dist and not slow"` is the fast core loop,
# `-m slow` the heavy single-device files, `-m dist` the virtual-mesh files,
# `-m gpu` the tests that need a GPU (skipped without one).
_DIST_FILES = ("test_dist_",)
_SLOW_FILES = (
    "test_properties.py",    # hypothesis property sweeps
)


def pytest_configure(config):
    config.addinivalue_line("markers", "dist: virtual-mesh distributed")
    config.addinivalue_line("markers", "slow: heavy single-device files")
    config.addinivalue_line("markers", "gpu: needs a GPU (skips without one)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = item.fspath.basename
        if fname.startswith(_DIST_FILES):
            item.add_marker(pytest.mark.dist)
        elif fname in _SLOW_FILES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the run has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible (run with RST_TEST_PLATFORMS=cpu,cuda "
                    "on a machine with one)")
