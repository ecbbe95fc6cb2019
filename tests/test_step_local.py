"""The per-shard step against the whole-grid reference, without shard_map.

``ops/step_local`` steps a row block given the two halo rows its ring
neighbours send; ``ops/step_jnp`` steps the whole torus with rolls. A block
that wraps onto itself, and a grid cut into blocks that trade edge rows,
must both reproduce the reference. Also the BGK equilibrium's moments and
the argument checks of ``make_runner``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm.core import physics
from tpulbm.core.lattice import CX, CY
from tpulbm.core.params import LBMParams
from tpulbm.core.state import initial_state
from tpulbm.dist.mesh import get_mesh, get_mesh_2d
from tpulbm.dist.runner import make_runner
from tpulbm.ops import step_jnp, step_local

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data")
SHAPES = [(6, 8), (16, 33), (24, 128), (9, 200)]


def _random_state(ny, nx, seed):
    params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < 0.15
    mask[params.accel_row, : nx // 2] = False
    params = params.with_free_cells(ny * nx - int(mask.sum()))
    f = np.asarray(initial_state(params)) * (
        1.0 + 0.2 * rng.rand(9, ny, nx).astype(np.float32))
    return params, jnp.asarray(f), jnp.asarray(mask)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_pull_local_self_wrap_matches_pull(ny, nx):
    _, f, _ = _random_state(ny, nx, seed=ny + nx)
    got = step_local.pull_local(f, f[:, -1, :], f[:, 0, :])
    want = step_jnp.pull(f)
    for k in range(9):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_local_step_self_wrap_matches_lbm_step(ny, nx):
    params, f, obst = _random_state(ny, nx, seed=3 * ny + nx)
    f_loc, tot_u = step_local.local_step_jnp(
        f, f[:, -1, :], f[:, 0, :], obst, jnp.int32(params.accel_row),
        params.omega, params.accel_w1, params.accel_w2)
    f_ref, av_ref = step_jnp.lbm_step(f, obst, params)
    np.testing.assert_allclose(np.asarray(f_loc), np.asarray(f_ref),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(tot_u) * params.free_cells_inv,
                               float(av_ref), rtol=1e-5)


@pytest.mark.parametrize("ny,nx", SHAPES[:3])
def test_accelerate_local_owner_matches_reference(ny, nx):
    params, f, obst = _random_state(ny, nx, seed=ny)
    got = step_local.accelerate_local(f, obst, jnp.int32(params.accel_row),
                                      params.accel_w1, params.accel_w2)
    want = step_jnp.accelerate(f, obst, params)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_accelerate_local_non_owner_is_identity():
    params, f, obst = _random_state(16, 33, seed=1)
    got = step_local.accelerate_local(f, obst, jnp.int32(-1),
                                      params.accel_w1, params.accel_w2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(f))


@pytest.mark.parametrize("n_blocks", [2, 3, 4, 6])
def test_blocks_trading_edge_rows_reassemble_the_step(n_blocks):
    """The ring's algebra by hand: each block pulls with its neighbours'
    edge rows (wrapping at the ends) and only the owner of the accelerated
    row accelerates; the blocks put together are the reference step."""
    ny, nx = 36, 40
    params, f, obst = _random_state(ny, nx, seed=n_blocks)
    h = ny // n_blocks
    blocks = [f[:, i * h:(i + 1) * h, :] for i in range(n_blocks)]
    masks = [obst[i * h:(i + 1) * h] for i in range(n_blocks)]
    out, tot = [], 0.0
    for i in range(n_blocks):
        lo = blocks[i - 1][:, -1, :]
        hi = blocks[(i + 1) % n_blocks][:, 0, :]
        r = params.accel_row - i * h
        accel = jnp.int32(r if 0 <= r < h else -1)
        g, t = step_local.local_step_jnp(
            blocks[i], lo, hi, masks[i], accel, params.omega,
            params.accel_w1, params.accel_w2)
        out.append(g)
        tot += float(t)
    f_ref, av_ref = step_jnp.lbm_step(f, obst, params)
    np.testing.assert_allclose(np.asarray(jnp.concatenate(out, axis=1)),
                               np.asarray(f_ref), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tot * params.free_cells_inv, float(av_ref),
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equilibrium_moments(seed):
    """The simplified BGK equilibrium keeps the cell's density and momentum
    (d2q9-bgk.c:592-647)."""
    t = list(np.random.RandomState(seed).rand(9, 4, 5).astype(np.float32)
             * 0.1 + 0.01)
    dens, densinv, m_x, m_y, u_sq = physics.macroscopics(t)
    feq = physics.equilibrium(dens, densinv, m_x, m_y, u_sq)
    np.testing.assert_allclose(sum(feq), dens, rtol=1e-5)
    np.testing.assert_allclose(sum(CX[k] * feq[k] for k in range(9)), m_x,
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(sum(CY[k] * feq[k] for k in range(9)), m_y,
                               rtol=1e-4, atol=1e-7)


def _params(ny, nx):
    return LBMParams(nx=nx, ny=ny, max_iters=2, reynolds_dim=10, density=0.1,
                     accel=0.005, omega=1.85).with_free_cells(ny * nx)


@pytest.mark.parametrize("ny,nx,mesh", [
    (2, 16, (1,)),      # fewer than 3 rows on one device
    (18, 32, (4, 2)),   # ny does not split over the torus rows
    (16, 10, (2, 4)),   # nx does not split into >= 3-column shards
], ids=["thin-1dev", "torus-uneven-rows", "torus-thin-columns"])
def test_make_runner_rejects_bad_shapes(ny, nx, mesh):
    m = get_mesh(n_devices=mesh[0]) if len(mesh) == 1 else get_mesh_2d(*mesh)
    with pytest.raises(ValueError):
        make_runner(_params(ny, nx), 2, mesh=m)


@pytest.mark.parametrize("shape", ["2x", "axb"])
def test_cli_rejects_malformed_mesh_shape(shape, capsys):
    from tpulbm.cli import main

    rc = main([os.path.join(DATA, "input_128x128.params"),
               os.path.join(DATA, "obstacles_128x128.dat"),
               "--mesh-shape", shape, "--no-output"])
    assert rc == 1
    assert "--mesh-shape must be DYxDX" in capsys.readouterr().err
