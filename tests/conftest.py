"""Test harness config: a virtual 8-device CPU mesh with x64 enabled.

Tests validate numerics against the reference's float64 scipy behavior, so
they run on CPU with x64 (the Pallas kernels in interpret mode), and the 8
virtual devices exercise the multi-device sharding paths.  Tests marked
``gpu`` need the card and skip elsewhere; run them on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` — when
``JAX_PLATFORMS`` names the GPU, this file leaves the platform alone.
"""
import os

_platforms = os.environ.get("JAX_PLATFORMS", "")
ON_GPU = any(p in _platforms for p in ("cuda", "gpu"))
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, at test time)."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"
        )


def load_golden(name):
    return np.load(os.path.join(GOLDEN, name))
