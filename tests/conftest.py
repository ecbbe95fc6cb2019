"""Test configuration: run on an 8-device virtual CPU mesh by default.

This exercises the real ppermute halo-exchange path without several cards
(SURVEY.md section 4 "Implication for the new framework"). Tests marked
``gpu`` need a card; run them on one with ``make test-gpu``, which sets
``JAX_PLATFORMS=cuda``. Whether a card is present is decided inside the
``gpu_device`` fixture, never while a module is imported.
"""

import os

_FLAG = "--xla_force_host_platform_device_count=8"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " " + _FLAG).strip()
if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "data")
GOLDEN = os.path.join(REPO, "tests", "goldens")


@pytest.fixture()
def gpu_device():
    """The first GPU, or a skip when JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def params_128():
    from tpulbm.io.params_file import read_params
    from tpulbm.io.obstacles import read_obstacles

    params = read_params(os.path.join(REFERENCE, "input_128x128.params"))
    mask, num_free = read_obstacles(
        os.path.join(REFERENCE, "obstacles_128x128.dat"), params.nx, params.ny
    )
    return params.with_free_cells(num_free), mask


@pytest.fixture(scope="session")
def golden_av_vels_128():
    return np.loadtxt(
        os.path.join(GOLDEN, "128x128.av_vels.dat"), usecols=[1], max_rows=512
    )
