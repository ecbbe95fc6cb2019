"""Scale demonstration: the SURVEY north-star configuration — a 4096x4096
grid sharded over an 8-device mesh — compiles and steps correctly (virtual
CPU mesh). Several 600 MB copies of the state make it a `slow` test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm.core.params import LBMParams
from tpulbm.core.state import initial_state
from tpulbm.diag.observables import total_density
from tpulbm.dist.mesh import get_mesh
from tpulbm.dist.runner import make_runner
from tpulbm.dist.sharding import shard_arrays
from tpulbm.tools.make_deck import box_obstacles

pytestmark = pytest.mark.slow


def test_4096_sharded_over_8_devices():
    ny = nx = 4096
    params = LBMParams(nx=nx, ny=ny, max_iters=2, reynolds_dim=10,
                       density=0.1, accel=0.01, omega=1.85)
    mask = box_obstacles(ny, nx)
    params = params.with_free_cells(ny * nx - int(mask.sum()))
    mesh = get_mesh(n_devices=8)
    runner = make_runner(params, 2, mesh=mesh)
    f, obst = shard_arrays(mesh, initial_state(params), jnp.asarray(mask))
    # state is genuinely sharded across the mesh
    assert len(f.sharding.device_set) == 8
    m0 = float(total_density(f))
    f, av = runner(f, obst)
    jax.block_until_ready(f)
    assert av.shape == (2,)
    assert np.all(np.isfinite(np.asarray(av))) and np.asarray(av)[0] > 0
    np.testing.assert_allclose(float(total_density(f)), m0, rtol=1e-4)
    assert len(f.sharding.device_set) == 8


def test_4096_sharded_matches_single_device_oracle():
    """Oracle-prefix correctness gate at scale: the 8-device sharded run's
    av_vels series and full state match a 1-device run of the same steps
    (decomposition invariance, the property the reference tests by running
    the MPI binary at any -np against serial goldens — SURVEY.md section 4)."""
    ny = nx = 4096
    n_steps = 3
    params = LBMParams(nx=nx, ny=ny, max_iters=n_steps, reynolds_dim=10,
                       density=0.1, accel=0.01, omega=1.85)
    mask = box_obstacles(ny, nx)
    params = params.with_free_cells(ny * nx - int(mask.sum()))

    mesh1 = get_mesh(n_devices=1)
    f1, obst1 = shard_arrays(mesh1, initial_state(params), jnp.asarray(mask))
    f1, av1 = make_runner(params, n_steps, mesh=mesh1)(f1, obst1)

    mesh8 = get_mesh(n_devices=8)
    f8, obst8 = shard_arrays(mesh8, initial_state(params), jnp.asarray(mask))
    f8, av8 = make_runner(params, n_steps, mesh=mesh8)(f8, obst8)

    # psum tree order may differ from the 1-device sum → tolerance, not bitwise
    np.testing.assert_allclose(np.asarray(av8), np.asarray(av1), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(f8), np.asarray(f1), rtol=1e-6, atol=1e-9
    )
