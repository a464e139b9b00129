"""Test bootstrap: an 8-virtual-device CPU mesh (SURVEY.md §5.4).

Tests run on the CPU with 8 virtual devices, so sharding logic is
exercised without hardware.  Tests marked ``gpu`` need the card: they
take the ``gpu_device`` fixture, which skips them unless JAX's default
device is a GPU.  For that, the session must be started with
``TRIGENIC_TEST_DEVICE=gpu`` in the environment, which leaves JAX's own
platform choice alone (``python chip_smoke.py`` runs them that way, in
its own process).
"""

import os

ON_DEVICE = os.environ.get("TRIGENIC_TEST_DEVICE") == "gpu"

if not ON_DEVICE:
    # Must be set before the CPU backend initializes.
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices()
    assert devs[0].platform == "cpu"
    return devs


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU; skips the test where JAX's default device is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform}); "
                    "run with TRIGENIC_TEST_DEVICE=gpu on the card")
    return dev


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
