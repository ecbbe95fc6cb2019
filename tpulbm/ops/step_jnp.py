"""Single-device reference implementation of the fused timestep, in pure jnp.

This is the readable oracle: full-grid pull-scheme streaming with
``jnp.roll`` (periodic in both axes), the masked inflow acceleration, BGK
collision and bounce-back, and the on-device |u| reduction. It reproduces the
fused ``timestep`` + ``accelerate_flow`` pair of the reference
(d2q9-bgk.c:442-704) as one pure function.

The runners in tpulbm.dist.runner, which step local blocks with halo rows
(tpulbm.ops.step_local), are differential-tested against this module.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpulbm.core.lattice import CX, CY, NSPEEDS
from tpulbm.core.params import LBMParams
from tpulbm.core import physics


def pull(f: jnp.ndarray) -> list[jnp.ndarray]:
    """Streaming by pull: t_k(y, x) = f_k(y - c_ky, x - c_kx), periodic.

    Equivalent to the gather loop of d2q9-bgk.c:520-540 with the halo rows
    replaced by a torus roll.
    """
    return [
        jnp.roll(f[k], shift=(CY[k], CX[k]), axis=(0, 1)) for k in range(NSPEEDS)
    ]


def accelerate(f: jnp.ndarray, obstacles: jnp.ndarray, params: LBMParams) -> jnp.ndarray:
    """Masked inflow acceleration of global row ny-2 (d2q9-bgk.c:442-478).

    Adds w1 to channel 1 and w2 to 5,8, subtracts the same from 3,6,7 — only
    where the cell is free and channels 3,6,7 stay positive after the update
    (the knife-edge guard of d2q9-bgk.c:457-460, reproduced exactly).
    """
    w1 = jnp.float32(params.accel_w1)
    w2 = jnp.float32(params.accel_w2)
    row = params.accel_row
    f3, f6, f7 = f[3, row], f[6, row], f[7, row]
    mask = (
        (~obstacles[row])
        & (f3 - w1 > 0.0)
        & (f6 - w2 > 0.0)
        & (f7 - w2 > 0.0)
    )
    zero = jnp.float32(0.0)
    dw1 = jnp.where(mask, w1, zero)
    dw2 = jnp.where(mask, w2, zero)
    upd = jnp.stack(
        [
            f[1, row] + dw1,
            f[3, row] - dw1,
            f[5, row] + dw2,
            f[6, row] - dw2,
            f[7, row] - dw2,
            f[8, row] + dw2,
        ]
    )
    return f.at[jnp.array([1, 3, 5, 6, 7, 8]), row].set(upd)


def collide_stream(f: jnp.ndarray, obstacles: jnp.ndarray, params: LBMParams):
    """One fused pull + collide + bounce-back sweep over the whole grid.

    Returns the new state and the float32 sum of |u| over free cells
    (the partial ``tot_u`` of d2q9-bgk.c:493-704).
    """
    t = pull(f)
    out, speed = physics.collide(t, obstacles, params.omega)
    return jnp.stack(out), jnp.sum(speed, dtype=jnp.float32)


def lbm_step(f: jnp.ndarray, obstacles: jnp.ndarray, params: LBMParams):
    """accelerate -> collide_stream, returning (f', av_vel) for this step.

    Matches the per-iteration order of the reference main loop
    (d2q9-bgk.c:315-394): accelerate_flow mutates the current grid, the fused
    sweep writes the next grid, and av_vels[tt] = tot_u * free_cells_inv.
    """
    f = accelerate(f, obstacles, params)
    f, tot_u = collide_stream(f, obstacles, params)
    return f, tot_u * jnp.float32(params.free_cells_inv)


@functools.partial(jax.jit, static_argnames=("params", "n_steps"), donate_argnums=0)
def run_steps(f: jnp.ndarray, obstacles: jnp.ndarray, params: LBMParams, n_steps: int):
    """Scan n_steps of lbm_step; returns (final state, av_vels series)."""

    def body(carry, _):
        f_new, av = lbm_step(carry, obstacles, params)
        return f_new, av

    return jax.lax.scan(body, f, None, length=n_steps)
