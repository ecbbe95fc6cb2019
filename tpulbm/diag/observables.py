"""Diagnostics over a (9, ny, nx) state.

Equivalents of the reference diagnostics layer:
- av_velocity (d2q9-bgk.c:707-757): mean |u| over free cells.
- calc_reynolds (d2q9-bgk.c:1002-1008): av_vel * reynolds_dim / viscosity.
- total_density (d2q9-bgk.c:1011-1032): mass-conservation check.

All are jittable; reductions happen on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpulbm.core.params import LBMParams


def moments(f: jnp.ndarray):
    """(density, momentum_x, momentum_y) per cell (d2q9-bgk.c:723-746)."""
    dens = jnp.sum(f, axis=0)
    m_x = f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])
    m_y = f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])
    return dens, m_x, m_y


def velocity_field(f: jnp.ndarray):
    """(u_x, u_y, |u|) with u = m / rho; not masked by obstacles."""
    dens, m_x, m_y = moments(f)
    u_x = m_x / dens
    u_y = m_y / dens
    return u_x, u_y, jnp.sqrt(u_x * u_x + u_y * u_y)


@jax.jit
def _av_velocity(f: jnp.ndarray, obstacles: jnp.ndarray, free_cells_inv):
    _, _, u = velocity_field(f)
    tot_u = jnp.sum(jnp.where(obstacles, jnp.float32(0.0), u), dtype=jnp.float32)
    return tot_u * free_cells_inv


def av_velocity(f: jnp.ndarray, obstacles: jnp.ndarray, params: LBMParams):
    return _av_velocity(f, obstacles, jnp.float32(params.free_cells_inv))


def calc_reynolds(f: jnp.ndarray, obstacles: jnp.ndarray, params: LBMParams):
    av = av_velocity(f, obstacles, params)
    return av * jnp.float32(params.reynolds_dim) / jnp.float32(params.viscosity)


@jax.jit
def total_density(f: jnp.ndarray):
    return jnp.sum(f, dtype=jnp.float32)


@jax.jit
def output_fields(f: jnp.ndarray, obstacles: jnp.ndarray, density):
    """(u_x, u_y, |u|, pressure) for final_state output, computed on device
    (obstacle cells: zero velocity, ambient pressure density/3 —
    d2q9-bgk.c:1076-1111). Transferring four (ny, nx) planes instead of the
    nine-channel state keeps host readback under half the bytes."""
    zero = jnp.float32(0.0)
    c_sq = jnp.float32(1.0) / jnp.float32(3.0)
    dens, m_x, m_y = moments(f)
    u_x = jnp.where(obstacles, zero, m_x / dens)
    u_y = jnp.where(obstacles, zero, m_y / dens)
    u = jnp.sqrt(u_x * u_x + u_y * u_y)
    pressure = jnp.where(
        obstacles, jnp.float32(density) * c_sq, dens * c_sq
    )
    return u_x, u_y, u, pressure
