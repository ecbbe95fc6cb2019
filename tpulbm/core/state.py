"""Lattice state construction.

The state is a single SoA tensor ``f`` of shape ``(9, ny, nx)`` float32 —
channel-major so the lane (last) dimension is ``x``. This replaces the
reference's AoS ``t_speed{float speeds[9]}`` grid (d2q9-bgk.c:95-98), which is
a CPU-cache layout, not a feature; on an accelerator the SoA layout makes
every channel a dense 2-D array whose x-streaming is a contiguous shift.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpulbm.core.lattice import NSPEEDS
from tpulbm.core.params import LBMParams


def initial_state(params: LBMParams) -> jnp.ndarray:
    """Equilibrium-at-rest initial condition (d2q9-bgk.c:879-902).

    Channel 0 gets ``density*4/9``, axis channels ``density/9``, diagonal
    channels ``density/36`` — all computed in float32.
    """
    rho = np.float32(params.density)
    w0 = rho * np.float32(4.0) / np.float32(9.0)
    w1 = rho / np.float32(9.0)
    w2 = rho / np.float32(36.0)
    per_channel = np.array([w0, w1, w1, w1, w1, w2, w2, w2, w2], dtype=np.float32)
    f = np.broadcast_to(
        per_channel[:, None, None], (NSPEEDS, params.ny, params.nx)
    ).copy()
    return jnp.asarray(f)
