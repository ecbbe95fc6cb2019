"""``make_runner`` against the plain reference, over every shard layout.

One parametrised differential: the runner that ``make_runner`` picks (the
1-D ring, the padded ring or the 2-D torus) must reproduce
``step_jnp.run_steps`` — whole-grid rolls, no halos — on random obstacles.
The cases cover aligned and unaligned ``nx``, ``ny`` that splits evenly or
not, 1, 2, 3, 4, 6 and 8 devices, and the accelerated row (global ny-2) in
the interior of a shard, on a shard's first or last row, and on a shard
that holds fewer real rows than the others.

The state is compared exactly up to float32 rounding: the runners evaluate
the same float32 expressions per cell, only the |u| reduction runs in
another order (per-shard partial sums, then the psum), hence the av
tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm.core.params import LBMParams
from tpulbm.core.state import initial_state
from tpulbm.dist.mesh import get_mesh, get_mesh_2d
from tpulbm.dist.runner import make_runner
from tpulbm.dist.sharding import padded_split, shard_arrays
from tpulbm.ops.step_jnp import run_steps

# (ny, nx, mesh shape, steps)
CASES = [
    # 1-D even ring: aligned nx
    (32, 128, (1,), 9),
    (32, 128, (2,), 9),
    (32, 128, (4,), 9),
    (32, 128, (8,), 9),
    # 1-D even ring: unaligned nx
    (48, 100, (1,), 9),
    (48, 100, (2,), 9),
    (48, 100, (4,), 9),
    (48, 100, (8,), 9),
    (40, 130, (8,), 7),
    (64, 200, (4,), 7),
    (9, 64, (3,), 12),
    (12, 64, (2,), 12),
    (5, 16, (1,), 16),
    # three-row shards: the accelerated row is the middle row of the last
    (24, 37, (8,), 12),
    # 1-D padded ring (ny does not split evenly into >= 3-row shards)
    (30, 128, (4,), 9),   # accel row interior to the last shard
    (13, 64, (4,), 12),   # accel row = last row of shard 2
    (14, 64, (4,), 12),   # accel row = first row of shard 3
    (11, 64, (4,), 12),   # accel row on a shard with 2 real rows
    (10, 50, (8,), 12),   # shards 4..7 hold only dead rows
    (17, 100, (8,), 12),  # accel row = first row of a 2-row shard
    (26, 96, (8,), 9),
    (100, 128, (8,), 7),
    (33, 40, (2,), 9),
    (7, 33, (2,), 12),
    (20, 64, (3,), 9),
    (8, 24, (6,), 12),    # more devices than 3-row shards need
    (16, 128, (8,), 9),   # even split, but 2-row shards: padded
    # 2-D torus
    (16, 128, (2, 4), 9),
    (16, 128, (4, 2), 9),
    (32, 96, (2, 2), 9),
    (24, 48, (1, 8), 9),
    (12, 24, (4, 2), 12),
    (9, 30, (3, 2), 12),
    (16, 40, (2, 4), 9),
    (8, 12, (2, 2), 16),
]


def _case_id(case):
    ny, nx, shape, n = case
    return f"{ny}x{nx}-" + "x".join(map(str, shape)) + f"-{n}steps"


def _problem(ny, nx, seed):
    params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.random.RandomState(seed).rand(ny, nx) < 0.1
    mask[params.accel_row, : nx // 2] = False  # let the inflow act
    return params.with_free_cells(ny * nx - int(mask.sum())), mask


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_runner_matches_reference(case):
    ny, nx, shape, n = case
    params, mask = _problem(ny, nx, seed=ny * 1000 + nx)
    obst = jnp.asarray(mask)
    f_ref, av_ref = run_steps(initial_state(params), obst, params, n)

    mesh = (get_mesh(n_devices=shape[0]) if len(shape) == 1
            else get_mesh_2d(*shape))
    runner = make_runner(params, n, mesh=mesh)
    f0, o0 = shard_arrays(mesh, initial_state(params), obst)
    f, av = runner(f0, o0)

    f, av = np.asarray(f), np.asarray(av)
    assert f.shape == (9, ny, nx) and av.shape == (n,)
    np.testing.assert_allclose(f, np.asarray(f_ref), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(av, np.asarray(av_ref), rtol=2e-5)
    # the inflow acted: the accelerated row differs from a rest state
    assert av[-1] > 0


@pytest.mark.parametrize("ny,n_dev", [(13, 4), (10, 8), (17, 8), (7, 2)])
def test_padded_layout_covers_the_grid(ny, n_dev):
    """The padded split keeps >= 3 rows per shard and covers every row."""
    rows, ny_pad = padded_split(ny, n_dev)
    assert rows >= 3
    assert ny_pad == rows * n_dev >= ny
    assert ny_pad - ny < rows or rows == 3
