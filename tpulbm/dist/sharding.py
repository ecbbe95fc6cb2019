"""Row-decomposition policy and sharding helpers.

The reference balances a remainder over ranks and forces the last rank to own
at least 3 rows so the accelerated row stays interior (d2q9-bgk.c:834-862).
This design shards the y-axis evenly instead and requires divisibility —
every shipped grid (128/256/1024/4096 rows) divides the natural mesh sizes —
which keeps shapes static for XLA and makes `ppermute` halo indexing uniform;
any other ``ny`` is padded to a divisible height (``padded_split``).
``decompose_rows`` still implements the reference's remainder-balanced split
(including the >=3-rows-for-the-last-rank rule) for API parity and for tests
that check equivalence of the two policies.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def decompose_rows(ny: int, n_ranks: int) -> Tuple[List[int], List[int]]:
    """(rows_per_rank, row_offsets) with the reference's balancing rules
    (d2q9-bgk.c:834-862)."""
    base = ny // n_ranks
    left = ny % n_ranks
    one_for_last = 0
    one_less_second_last = 0
    if base < 3 and left:
        left -= 1
        one_for_last = 1
    elif base < 3 and not left:
        one_for_last = 1
        one_less_second_last = 1
    ny_local = []
    displs = []
    for proc in range(n_ranks):
        if proc < n_ranks - 2:
            rows = base
        elif proc == n_ranks - 2:
            rows = base - one_less_second_last
        else:
            rows = base + one_for_last
        if proc < left:
            rows += 1
        ny_local.append(rows)
        displs.append(0 if proc == 0 else displs[proc - 1] + ny_local[proc - 1])
    return ny_local, displs


def padded_split(ny: int, n_devices: int) -> Tuple[int, int]:
    """(rows_per_shard, ny_pad) for the pad-to-divisible policy (SURVEY §7).

    Any ny runs on any device count — the static-shape counterpart of the
    reference's any ``-np`` remainder-balanced split (d2q9-bgk.c:834-862) — by
    padding the grid to ``rows_per_shard * n_devices`` rows with masked dead
    rows, keeping every shard shape static and identical for XLA. Shards are at least 3 rows
    tall (same motivation as the reference's last-rank >=3-rows rule).
    """
    rows = max(3, -(-ny // n_devices))
    return rows, rows * n_devices


def validate_even_split(ny: int, n_devices: int) -> int:
    """Rows per device for the even row split; raises if invalid."""
    if ny % n_devices != 0:
        raise ValueError(
            f"ny={ny} must divide evenly over {n_devices} devices "
            "(pad the grid or choose a different mesh)"
        )
    rows = ny // n_devices
    if rows < 3:
        raise ValueError(
            f"each device needs >= 3 rows (got {rows}); the accelerated row "
            "must stay interior to its shard (see d2q9-bgk.c:838-849)"
        )
    return rows


def validate_even_col_split(nx: int, n_devices: int) -> int:
    """Columns per device for the 2-D torus split; raises if invalid."""
    if nx % n_devices != 0 or nx // n_devices < 3:
        raise ValueError(
            f"nx={nx} must split evenly into >=3-column shards over "
            f"{n_devices} devices"
        )
    return nx // n_devices


def row_sharding(mesh: Mesh, axis_name: str = "y"):
    """(state_sharding, mask_sharding) for the mesh: the y axis of
    (9, ny, nx)/(ny, nx) arrays over a 1-D mesh, or both grid axes over a
    2-D ('y', 'x') torus mesh."""
    if len(mesh.axis_names) == 2:
        ay, ax = mesh.axis_names
        return (
            NamedSharding(mesh, P(None, ay, ax)),
            NamedSharding(mesh, P(ay, ax)),
        )
    state = NamedSharding(mesh, P(None, axis_name, None))
    mask = NamedSharding(mesh, P(axis_name, None))
    return state, mask


def shard_arrays(mesh: Mesh, f, obstacles, axis_name: str = "y"):
    if (
        len(mesh.axis_names) == 1
        and f.shape[1] % mesh.devices.size != 0
    ):
        # Uneven ny: device_put can't row-shard it. Leave the arrays
        # unsharded — the padded runner pads to divisible and installs the
        # sharding inside jit (with_sharding_constraint).
        import jax.numpy as jnp

        return jnp.asarray(f), jnp.asarray(obstacles)
    state_s, mask_s = row_sharding(mesh, axis_name)
    return jax.device_put(f, state_s), jax.device_put(obstacles, mask_s)
