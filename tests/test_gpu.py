"""Tests that need an NVIDIA GPU (marker ``gpu``; ``make test-gpu``).

They skip with a reason where JAX finds no GPU. Whether one is present is
decided in the ``gpu_device`` fixture, at run time."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm.core.state import initial_state
from tpulbm.dist.mesh import get_mesh
from tpulbm.dist.runner import make_runner
from tpulbm.ops.step_jnp import run_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_runner_matches_reference_on_gpu(gpu_device, params_128):
    params, mask = params_128
    obst = jax.device_put(jnp.asarray(mask), gpu_device)
    runner = make_runner(params, 100, mesh=get_mesh(devices=[gpu_device]))
    f, av = runner(initial_state(params), obst)
    f_ref, av_ref = run_steps(initial_state(params), obst, params, 100)
    assert f.devices() == {gpu_device}
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), atol=1e-6)
    np.testing.assert_allclose(np.asarray(av), np.asarray(av_ref), rtol=1e-5)


@pytest.mark.gpu
def test_cli_golden_prefix_on_gpu(gpu_device, tmp_path):
    from tpulbm.cli import main

    rc = main([os.path.join(REPO, "data", "input_128x128.params"),
               os.path.join(REPO, "data", "obstacles_128x128.dat"),
               "--device-count", "1", "--max-iters", "2000",
               "--out-dir", str(tmp_path)])
    assert rc == 0
    av = np.loadtxt(tmp_path / "av_vels.dat", usecols=[1])
    ref = np.loadtxt(os.path.join(REPO, "tests", "goldens",
                                  "128x128.av_vels.dat"),
                     usecols=[1], max_rows=2000)
    assert np.max(np.abs(av - ref) / np.abs(ref)) < 0.01
