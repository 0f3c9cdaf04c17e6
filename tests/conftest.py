"""Test configuration: by default everything runs on a virtual 8-device CPU
mesh.

Multi-device sharding (gpann_tpu.dist) is validated on
``--xla_force_host_platform_device_count=8`` per the reference-parity test
strategy (SURVEY.md §4): the reference has no tests at all; we add the pyramid
it lacks — NumPy oracles, property tests, golden-metric integration tests, and
multi-device tests runnable without a cluster.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on a machine with
one, run them with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(555)  # the reference's seed convention


@pytest.fixture
def gpu():
    """The first JAX device, if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda pytest -m gpu")
    return dev
