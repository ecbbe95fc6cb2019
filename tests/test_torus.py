"""2-D torus decomposition: both grid axes sharded over a ('y','x') mesh —
the tiled layout the reference's report declined. Two-phase halo exchange
(columns, then rows of the extended block) carries the corner cells."""

import os
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm.core.state import initial_state
from tpulbm.dist.mesh import get_mesh_2d
from tpulbm.dist.runner import make_runner
from tpulbm.ops.step_jnp import run_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dy,dx", [(2, 4), (4, 2), (2, 2), (1, 8)])
def test_torus_matches_oracle(params_128, dy, dx):
    params, mask = params_128
    obst = jnp.asarray(mask)
    n = 25
    f_ref, av_ref = run_steps(initial_state(params), obst, params, n)
    runner = make_runner(params, n, mesh=get_mesh_2d(dy, dx))
    f, av = runner(initial_state(params), obst)
    assert np.array_equal(np.asarray(f), np.asarray(f_ref))
    np.testing.assert_allclose(np.asarray(av), np.asarray(av_ref), rtol=2e-5)


def test_torus_cli(tmp_path, capsys):
    from tpulbm.cli import main

    rc = main([os.path.join(REPO, "data", "input_128x128.params"),
               os.path.join(REPO, "data", "obstacles_128x128.dat"),
               "--mesh-shape", "2x4", "--max-iters", "8",
               "--out-dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Reynolds number" in out
    assert (tmp_path / "av_vels.dat").exists()


def test_torus_rejects_thin_columns():
    from tpulbm.core.params import LBMParams

    p = LBMParams(nx=8, ny=64, max_iters=2, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85).with_free_cells(512)
    with pytest.raises(ValueError, match="column"):
        make_runner(p, 2, mesh=get_mesh_2d(1, 8))
