"""The D2Q9-BGK collision physics on pulled (post-streaming) populations.

These functions operate on a tuple/list of nine equal-shape float32 arrays
``t[k]`` — the populations that have just streamed *into* each cell — and
mirror the algebraically simplified equilibrium of the reference hot loop
(d2q9-bgk.c:542-700). All arithmetic stays in float32.

Key identity: the reference never normalises velocity before the equilibrium;
with momentum m = sum_k t_k c_k and density rho the simplified form is

    feq_k = w_k * (rho + 3 (m.c_k) + (3 / (2 rho)) * (3 (m.c_k)^2 - |m|^2))

(d2q9-bgk.c:638-647), and the per-cell |u| used for the average-velocity
series is |m| / rho (d2q9-bgk.c:667).
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np

from tpulbm.core.lattice import NSPEEDS, OPP, W0, W1, W2

_HALF = np.float32(0.5)
_IC_SQ = np.float32(3.0)


def macroscopics(t: Sequence[jnp.ndarray]):
    """density, 1/density, momentum components and |m|^2 (d2q9-bgk.c:542-590)."""
    dens = t[0] + t[1] + t[2] + t[3] + t[4] + t[5] + t[6] + t[7] + t[8]
    densinv = np.float32(1.0) / dens
    m_x = t[1] + t[5] + t[8] - t[3] - t[6] - t[7]
    m_y = t[2] + t[5] + t[6] - t[4] - t[7] - t[8]
    u_sq = m_x * m_x + m_y * m_y
    return dens, densinv, m_x, m_y, u_sq


def equilibrium(dens, densinv, m_x, m_y, u_sq):
    """The nine simplified BGK equilibria (d2q9-bgk.c:592-647)."""
    # Projections m . c_k for k = 1..8.
    mu = (
        None,
        m_x,
        m_y,
        -m_x,
        -m_y,
        m_x + m_y,
        -m_x + m_y,
        -m_x - m_y,
        m_x - m_y,
    )
    half_inv3 = _HALF * densinv * _IC_SQ
    feq0 = W0 * (dens - half_inv3 * u_sq)
    feq = [feq0]
    for k in range(1, NSPEEDS):
        w = W1 if k <= 4 else W2
        imu = mu[k] * _IC_SQ  # 3 (m.c_k)
        feq.append(w * (dens + imu + half_inv3 * (imu * mu[k] - u_sq)))
    return feq


def collide(
    t: Sequence[jnp.ndarray],
    obstacle_mask: jnp.ndarray,
    omega,
):
    """BGK relax on free cells, bounce-back on obstacles; also returns the
    per-cell |u| contribution (zero on obstacles).

    ``obstacle_mask`` is boolean with True on blocked cells. Mirrors
    d2q9-bgk.c:649-700.
    """
    dens, densinv, m_x, m_y, u_sq = macroscopics(t)
    feq = equilibrium(dens, densinv, m_x, m_y, u_sq)
    om = np.float32(omega)
    out = []
    for k in range(NSPEEDS):
        relaxed = t[k] + om * (feq[k] - t[k])
        out.append(jnp.where(obstacle_mask, t[OPP[k]], relaxed))
    speed = jnp.where(
        obstacle_mask, np.float32(0.0), jnp.sqrt(u_sq) * densinv
    )
    return out, speed
