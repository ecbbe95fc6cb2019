"""Device-mesh construction.

The reference's process topology is a 1-D ring of MPI ranks over grid rows
(d2q9-bgk.c:244-247,834-862). The equivalent here is a 1-D
``jax.sharding.Mesh`` whose single axis shards the y-dimension; neighbour
halo traffic is ``lax.ppermute``, which XLA lowers to collective permutes
(NCCL on GPUs). The mesh follows the algorithm, a ring, not the wiring: the
cards of one host are joined all to all.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

AXIS = "y"
AXIS_X = "x"


def get_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
    axis_name: str = AXIS,
) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"requested {n_devices} devices, have {len(devices)}"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def get_mesh_2d(
    dy: int,
    dx: int,
    devices: Optional[Sequence[jax.Device]] = None,
    axis_names: tuple = (AXIS, AXIS_X),
) -> Mesh:
    """2-D torus mesh sharding both grid axes — the tiled decomposition the
    reference's report considered and declined for layout reasons
    (report.odt "MPI Design")."""
    if devices is None:
        devices = jax.devices()
    if dy * dx > len(devices):
        raise ValueError(
            f"requested {dy}x{dx} devices, have {len(devices)}"
        )
    grid = np.asarray(devices[: dy * dx]).reshape(dy, dx)
    return Mesh(grid, axis_names)
