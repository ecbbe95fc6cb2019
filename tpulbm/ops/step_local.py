"""Per-shard (local-block) step used by the sharded runner.

Operates on a local row-block ``f_local`` of shape (9, H, nx) plus the two
halo rows received from ring neighbours — the counterpart of the
reference's halo-row machinery (d2q9-bgk.c:295-366). The x-axis stays
periodic inside the block (a roll along x); the y-axis periodicity comes
from the ring wrap-around of the halo exchange.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpulbm.core.lattice import CX, CY, NSPEEDS
from tpulbm.core import physics


def pull_local(f_local: jnp.ndarray, halo_lo: jnp.ndarray, halo_hi: jnp.ndarray):
    """Pull-streaming into each interior cell.

    ``halo_lo`` (9, nx) is the global row just below the block's first row;
    ``halo_hi`` the row just above its last (both already x-unshifted).
    Mirrors the gather of d2q9-bgk.c:520-540.
    """
    h = f_local.shape[1]
    ext = jnp.concatenate(
        [halo_lo[:, None, :], f_local, halo_hi[:, None, :]], axis=1
    )
    # Source row for local row i of channel k is i - CY[k]; in ext coords
    # that is a static slice starting at 1 - CY[k].
    return [
        jnp.roll(ext[k, 1 - CY[k] : 1 - CY[k] + h, :], CX[k], axis=1)
        for k in range(NSPEEDS)
    ]


def accelerate_local(
    f_local: jnp.ndarray,
    obstacles: jnp.ndarray,
    accel_row: jnp.ndarray,
    w1,
    w2,
):
    """Masked inflow acceleration of one local row (d2q9-bgk.c:442-478).

    ``accel_row`` is a traced int32 scalar: the local index of global row
    ny-2 on its owning shard, and -1 elsewhere. Non-owners rewrite a row with
    zero deltas, keeping the program uniform across the mesh (SPMD, no
    divergent control flow).
    """
    r = jnp.maximum(accel_row, 0)
    active = accel_row >= 0
    row = jax.lax.dynamic_slice_in_dim(f_local, r, 1, axis=1)  # (9, 1, nx)
    orow = jax.lax.dynamic_slice_in_dim(obstacles, r, 1, axis=0)  # (1, nx)
    w1 = jnp.float32(w1)
    w2 = jnp.float32(w2)
    mask = (
        active
        & (~orow)
        & (row[3] - w1 > 0.0)
        & (row[6] - w2 > 0.0)
        & (row[7] - w2 > 0.0)
    )
    zero = jnp.float32(0.0)
    dw1 = jnp.where(mask, w1, zero)
    dw2 = jnp.where(mask, w2, zero)
    new_row = jnp.stack(
        [
            row[0],
            row[1] + dw1,
            row[2],
            row[3] - dw1,
            row[4],
            row[5] + dw2,
            row[6] - dw2,
            row[7] - dw2,
            row[8] + dw2,
        ]
    )
    return jax.lax.dynamic_update_slice_in_dim(f_local, new_row, r, axis=1)


def local_step_jnp(
    f_local: jnp.ndarray,
    halo_lo: jnp.ndarray,
    halo_hi: jnp.ndarray,
    obstacles: jnp.ndarray,
    accel_row: jnp.ndarray,
    omega,
    accel_w1,
    accel_w2,
):
    """Full fused local step: accelerate -> pull -> collide/bounce-back.

    Returns (f_local', tot_u_partial). This is the step the runners in
    tpulbm.dist.runner scan; XLA fuses it.
    """
    f_local = accelerate_local(f_local, obstacles, accel_row, accel_w1, accel_w2)
    # Halos were captured before acceleration; that is safe because the
    # accelerated row is never a shard-boundary row (H >= 3, the same
    # invariant the reference enforces at d2q9-bgk.c:838-849).
    t = pull_local(f_local, halo_lo, halo_hi)
    out, speed = physics.collide(t, obstacles, omega)
    return jnp.stack(out), jnp.sum(speed, dtype=jnp.float32)
