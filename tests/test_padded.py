"""Pad-to-divisible decomposition: any ny over any device count.

The reference runs at any MPI size via its remainder-balanced split
(d2q9-bgk.c:834-862). The static-shape counterpart pads the grid to
rows_per_shard * n_devices with masked dead rows (SURVEY.md section 7) and
must reproduce the single-device run — golden-prefix gated on the official
128x128 deck at odd device counts, decomposition-invariance gated on
generated unaligned decks, CLI included.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm.core.params import LBMParams
from tpulbm.core.state import initial_state
from tpulbm.dist.mesh import get_mesh
from tpulbm.dist.runner import make_runner
from tpulbm.dist.sharding import padded_split
from tpulbm.ops.step_jnp import run_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_STEPS = 512


def test_padded_split_policy():
    assert padded_split(128, 3) == (43, 129)
    assert padded_split(128, 7) == (19, 133)
    assert padded_split(130, 8) == (17, 136)
    assert padded_split(128, 8) == (16, 128)  # aligned: no padding
    assert padded_split(8, 8) == (3, 24)  # >=3-row floor -> dead shards


@pytest.mark.parametrize("n_dev", [3, 5, 7])
def test_golden_prefix_odd_device_counts(params_128, golden_av_vels_128, n_dev):
    """The official 128x128 deck on device counts that don't divide ny: the
    av_vels prefix must satisfy the reference checker's 1% gate and the state
    must match the 1-device oracle."""
    params, mask = params_128
    mesh = get_mesh(n_devices=n_dev)
    runner = make_runner(params, N_STEPS, mesh=mesh)
    f, av = runner(initial_state(params), jnp.asarray(mask))
    av = np.asarray(av)
    diff_pcnt = 100.0 * np.abs(av - golden_av_vels_128) / golden_av_vels_128
    assert np.all(np.isfinite(diff_pcnt)) and diff_pcnt.max() < 1.0

    f_ref, av_ref = run_steps(
        initial_state(params), jnp.asarray(mask), params, N_STEPS
    )
    np.testing.assert_allclose(
        np.asarray(f), np.asarray(f_ref), rtol=1e-6, atol=1e-9
    )


@pytest.mark.parametrize(
    "ny,nx,n_dev",
    [
        (130, 200, 8),  # neither axis aligned (nx % 128 != 0 too)
        (14, 128, 4),   # accel row ny-2 lands on a shard edge
        (8, 64, 8),     # >=3-row floor -> shards 3..7 entirely dead
    ],
)
def test_unaligned_matches_single_device(ny, nx, n_dev):
    params = LBMParams(
        nx=nx, ny=ny, max_iters=24, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    rng = np.random.RandomState(3)
    mask = rng.rand(ny, nx) < 0.06
    params = params.with_free_cells(ny * nx - int(mask.sum()))
    f0 = initial_state(params)
    f1, av1 = make_runner(params, 24, mesh=get_mesh(n_devices=1))(
        jnp.array(f0), jnp.asarray(mask))
    fn, avn = make_runner(params, 24, mesh=get_mesh(n_devices=n_dev))(
        jnp.array(f0), jnp.asarray(mask))
    np.testing.assert_allclose(
        np.asarray(fn), np.asarray(f1), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(np.asarray(avn), np.asarray(av1), rtol=1e-5)


def test_cli_unaligned_deck_device_count_invariant(tmp_path):
    """End-to-end CLI on a generated 130x200 deck: an 8-device run writes the
    same outputs as a 1-device run (the reference's any--np property)."""
    from tpulbm.tools.make_deck import make_deck

    deck = tmp_path / "deck"
    ppath, opath = make_deck(nx=200, ny=130, iters=40, out_dir=str(deck))
    outs = {}
    for n_dev in (1, 8):
        out = tmp_path / f"out{n_dev}"
        env = dict(
            os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            JAX_PLATFORMS="cpu",
            PYTHONPATH=os.pathsep.join(
                [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep)
            ),
        )
        proc = subprocess.run(
            [sys.executable, "-m", "tpulbm", ppath, opath,
             "--device-count", str(n_dev),
             "--out-dir", str(out)],
            capture_output=True, text=True, env=env, timeout=600,
        )
        assert proc.returncode == 0, proc.stderr
        outs[n_dev] = (
            (out / "av_vels.dat").read_text(),
            (out / "final_state.dat").read_text(),
        )
    # final_state is bitwise-identical (the padded path reproduces the
    # 1-device state exactly); av_vels differs only in reduction order
    # (psum tree vs single-device sum), so compare numerically.
    assert outs[1][1] == outs[8][1]
    av1 = np.loadtxt(outs[1][0].splitlines(), usecols=[1])
    av8 = np.loadtxt(outs[8][0].splitlines(), usecols=[1])
    np.testing.assert_allclose(av8, av1, rtol=1e-5)
