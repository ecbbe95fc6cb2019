"""Golden-prefix regression on every deck that ships goldens.

The reference golden series records EVERY timestep, so short prefixes give a
strong cross-grid physics check without 40000-80000 iterations (gate 1%;
observed float-vs-double drift is ~0.1%)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm.core.state import initial_state
from tpulbm.dist.mesh import get_mesh
from tpulbm.dist.runner import make_runner
from tpulbm.io.obstacles import read_obstacles
from tpulbm.io.params_file import read_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATA = os.path.join(REPO, "data")
GOLDEN = os.path.join(REPO, "tests", "goldens")


@pytest.mark.parametrize("deck,n_dev", [
    ("128x256", 8),
    ("256x256", 4),
    ("1024x1024", 2),
])
def test_golden_prefix(deck, n_dev):
    n = 64 if deck == "1024x1024" else 128  # CPU budget
    params = read_params(os.path.join(DATA, f"input_{deck}.params"))
    mask, num_free = read_obstacles(
        os.path.join(DATA, f"obstacles_{deck}.dat"), params.nx, params.ny
    )
    params = params.with_free_cells(num_free)
    runner = make_runner(params, n, mesh=get_mesh(n_devices=n_dev))
    _, av = runner(initial_state(params), jnp.asarray(mask))
    golden = np.loadtxt(
        os.path.join(GOLDEN, f"{deck}.av_vels.dat"), usecols=[1], max_rows=n
    )
    rel = np.abs(np.asarray(av, dtype=np.float64) - golden) / np.abs(golden)
    assert rel.max() < 0.01, f"{deck}: max rel {rel.max():.2e} @ {rel.argmax()}"
