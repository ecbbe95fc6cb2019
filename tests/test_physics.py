"""Physics correctness of the single-device jnp oracle."""

import os
import jax.numpy as jnp
import numpy as np

from tpulbm.core.state import initial_state
from tpulbm.diag.observables import total_density
from tpulbm.ops.step_jnp import accelerate, collide_stream, run_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_golden_prefix_128(params_128, golden_av_vels_128):
    """First 512 per-step average velocities match the reference goldens.

    The golden series records EVERY step, so a prefix comparison is a strong
    fast check without running all 40000 iterations (gate: 1%,
    check/check.py:26-31; observed float-vs-double drift is ~0.1%)."""
    params, mask = params_128
    n = golden_av_vels_128.size
    f, av = run_steps(initial_state(params), jnp.asarray(mask), params, n)
    av = np.asarray(av, dtype=np.float64)
    rel = np.abs(av - golden_av_vels_128) / np.abs(golden_av_vels_128)
    assert rel.max() < 0.01, f"max rel diff {rel.max():.3e} at step {rel.argmax()}"


def test_mass_conservation(params_128):
    """Streaming + BGK + bounce-back conserve mass exactly (up to fp32);
    only accelerate_flow injects momentum, never mass (d2q9-bgk.c:462-469
    adds and subtracts equal weights)."""
    params, mask = params_128
    obst = jnp.asarray(mask)
    f = initial_state(params)
    m0 = float(total_density(f))
    f, _ = run_steps(f, obst, params, 100)
    m1 = float(total_density(f))
    assert abs(m1 - m0) / m0 < 1e-4


def test_collision_without_obstacles_preserves_momentum(params_128):
    """BGK relaxation preserves per-cell density and momentum: summing the
    post-collision populations reproduces the pre-collision macroscopics."""
    params, _ = params_128
    rng = np.random.RandomState(3)
    f = jnp.asarray(
        (0.1 + 0.01 * rng.rand(9, 16, 128)).astype(np.float32)
    )
    no_obst = jnp.zeros((16, 128), dtype=bool)
    f2, _ = collide_stream(f, no_obst, params)
    # compare total momentum (global streaming preserves totals too)
    def mom(g):
        mx = g[1] + g[5] + g[8] - g[3] - g[6] - g[7]
        my = g[2] + g[5] + g[6] - g[4] - g[7] - g[8]
        return float(jnp.sum(mx)), float(jnp.sum(my))

    np.testing.assert_allclose(mom(f2), mom(f), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(float(jnp.sum(f2)), float(jnp.sum(f)), rtol=1e-5)


def test_bounce_back_reverses_populations(params_128):
    """A fully-blocked grid only permutes populations (1<->3, 2<->4, 5<->7,
    6<->8) after streaming; no relaxation happens (d2q9-bgk.c:687-695)."""
    params, _ = params_128
    rng = np.random.RandomState(4)
    f = jnp.asarray((0.1 + 0.01 * rng.rand(9, 8, 128)).astype(np.float32))
    all_obst = jnp.ones((8, 128), dtype=bool)
    f2, tot_u = collide_stream(f, all_obst, params)
    assert float(tot_u) == 0.0
    # mass is exactly conserved cell-population-wise under pure bounce-back
    np.testing.assert_array_equal(
        np.sort(np.asarray(f2), axis=None), np.sort(np.asarray(f), axis=None)
    )


def test_accelerate_guard_and_row(params_128):
    params, mask = params_128
    obst = jnp.asarray(mask)
    f = initial_state(params)
    f2 = accelerate(f, obst, params)
    d = np.asarray(f2) - np.asarray(f)
    # Only row ny-2 changes.
    changed_rows = np.unique(np.nonzero(d)[1])
    assert changed_rows.tolist() == [params.ny - 2]
    row = params.ny - 2
    free = ~np.asarray(mask)[row]
    w1 = np.float32(params.accel_w1)
    w2 = np.float32(params.accel_w2)
    np.testing.assert_allclose(d[1, row][free], w1, rtol=1e-4)
    np.testing.assert_allclose(d[3, row][free], -w1, rtol=1e-4)
    for k, s in ((5, 1), (6, -1), (7, -1), (8, 1)):
        np.testing.assert_allclose(d[k, row][free], s * w2, rtol=1e-3)
    # Blocked cells unchanged.
    assert np.all(d[:, row][:, ~free] == 0)
    # Mass unchanged (momentum-only forcing).
    assert abs(d.sum()) < 1e-5


def test_f64_jax_oracle_matches_numpy_oracle():
    """The XLA-compiled f64 oracle (scripts/validate_f64.run_f64_jax — used
    to generate the large final-state goldens) reproduces the interpreted
    NumPy oracle to ~1e-13 over 100 steps on the official 128x128 deck.
    Subprocess-isolated because run_f64_jax enables jax_enable_x64
    globally."""
    import subprocess
    import sys

    code = """
import sys
sys.path.insert(0, ".")
sys.path.insert(0, "scripts")
import numpy as np
from validate_f64 import run_f64, run_f64_jax
from tpulbm.io.params_file import read_params
from tpulbm.io.obstacles import read_obstacles

p = read_params("data/input_128x128.params")
obst, nf = read_obstacles("data/obstacles_128x128.dat", p.nx, p.ny)
p = p.with_free_cells(nf)
f_np, av_np = run_f64(p, obst, 100)
f_jx, av_jx = run_f64_jax(p, obst, 100)
state = np.abs((f_jx - f_np) / np.where(f_np != 0, f_np, 1)).max()
av = np.abs((av_jx - av_np) / av_np).max()
assert state < 1e-12, state
assert av < 1e-12, av
print("OK", state, av)
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("OK")
