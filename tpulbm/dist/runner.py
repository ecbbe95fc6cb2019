"""The sharded step-loop runner.

Composes the whole distributed architecture in one ``shard_map``:

- halo rows move between ring neighbours via ``lax.ppermute`` once per
  step, replacing the persistent per-step MPI requests of
  d2q9-bgk.c:295-313,326-366; the periodic y-boundary is the ring
  wrap-around, exactly as the reference's neighbour arithmetic
  (d2q9-bgk.c:245-247);
- the per-step average-velocity series accumulates locally inside the scan
  and is reduced with ONE deferred ``psum`` after the loop, mirroring the
  reference's single post-loop ``MPI_Reduce`` (d2q9-bgk.c:367-374,396).

The local step is plain ``jax.numpy`` (``ops.step_local``) that XLA fuses.
``make_runner`` picks one of three layouts:

1. the 1-D ring over rows, for ``ny`` that splits evenly into >= 3-row
   shards (one device: the ring degenerates to a self-wrap with no
   collectives);
2. the padded ring, for any other ``(ny, n_devices)``: dead rows padded to
   a divisible height (``_make_padded_runner``);
3. the 2-D torus, when the mesh has two axes (``_make_runner_2d``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tpulbm.core import physics
from tpulbm.core.lattice import CX, CY, NSPEEDS, WEIGHTS
from tpulbm.core.params import LBMParams
from tpulbm.dist.mesh import AXIS, get_mesh
from tpulbm.dist.sharding import (
    padded_split,
    validate_even_col_split,
    validate_even_split,
)
from tpulbm.ops import step_local


def _local_accel_row(accel_glob: int, axis_name: str, rows: int):
    """Local index of the accelerated global row on this shard, -1 on the
    shards that do not own it."""
    r = accel_glob - jax.lax.axis_index(axis_name) * rows
    return jnp.where((r >= 0) & (r < rows), r, jnp.int32(-1)).astype(jnp.int32)


def _make_ring_runner(params: LBMParams, n_steps: int, mesh: Mesh,
                      axis_name: str):
    """Even row split over the 1-D ring: one width-1 halo row each way per
    step, one deferred psum of the |u| series."""
    n_dev = mesh.devices.size
    rows_local = validate_even_split(params.ny, n_dev)
    omega = float(params.omega)
    w1 = float(params.accel_w1)
    w2 = float(params.accel_w2)
    free_inv = jnp.float32(params.free_cells_inv)
    accel_row_global = params.accel_row

    def local_step(f_loc, halo_lo, halo_hi, obst, accel_row):
        return step_local.local_step_jnp(
            f_loc, halo_lo, halo_hi, obst, accel_row, omega, w1, w2
        )

    if n_dev == 1:
        # Single-device fast path: the ring degenerates to self-wrap, so the
        # halo rows are the block's own edge rows and no collectives are
        # needed. Equivalence with the ring path is covered by the
        # device-count invariance tests.
        accel_row_local = jnp.int32(accel_row_global)

        @functools.partial(jax.jit, donate_argnums=0)
        def runner_single(f, obstacles):
            def one_step(g, _):
                f_new, tot_u = local_step(
                    g, g[:, -1, :], g[:, 0, :], obstacles, accel_row_local
                )
                return f_new, tot_u * free_inv

            return jax.lax.scan(one_step, f, None, length=n_steps)

        return runner_single

    perm_fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    perm_bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def body(f_loc, obst_loc):
        accel_row_local = _local_accel_row(accel_row_global, axis_name,
                                           rows_local)

        def one_step(f, _):
            # My last interior row becomes the next device's halo_lo; my
            # first interior row becomes the previous device's halo_hi.
            halo_lo = jax.lax.ppermute(f[:, -1, :], axis_name, perm_fwd)
            halo_hi = jax.lax.ppermute(f[:, 0, :], axis_name, perm_bwd)
            f_new, tot_u = local_step(f, halo_lo, halo_hi, obst_loc,
                                      accel_row_local)
            return f_new, tot_u * free_inv

        f_out, av_local = jax.lax.scan(one_step, f_loc, None, length=n_steps)
        return f_out, jax.lax.psum(av_local, axis_name)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis_name, None), P(axis_name, None)),
        out_specs=(P(None, axis_name, None), P()),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=0)
    def runner(f, obstacles):
        return sharded(f, obstacles)

    return runner


def _make_padded_runner(
    params: LBMParams,
    n_steps: int,
    mesh: Mesh,
    axis_name: str = AXIS,
):
    """Sharded runner for any (ny, n_devices): pad-to-divisible with masked
    dead rows (SURVEY.md §7), the static-shape counterpart of the reference's
    remainder-balanced any--np split (d2q9-bgk.c:834-862).

    The grid is padded at the end to ``rows * n_dev`` rows; dead rows are
    marked as obstacles (excluded from the av series, bounded by bounce-back)
    and initialized to the rest equilibrium. Real shards 0..L form the halo
    ring; shard L sends its *last real* row down to shard 0 (the periodic
    wrap), and the received wrap row is placed immediately after each shard's
    last real row before the pull, so row ny-1 pulls the true global row 0.
    Acceleration happens before the halo capture so the scheme stays correct
    even when global row ny-2 lands on a shard edge (the case the reference
    excludes via its last-rank >=3-rows rule).
    """
    from jax.sharding import NamedSharding

    n_dev = mesh.devices.size
    ny, nx = params.ny, params.nx
    rows, ny_pad = padded_split(ny, n_dev)
    pad = ny_pad - ny
    last = (ny - 1) // rows  # last shard holding real rows
    n_real = [min(max(ny - j * rows, 0), rows) for j in range(n_dev)]
    perm_fwd = [(j, j + 1) for j in range(last)] + [(last, 0)]
    perm_bwd = [(j + 1, j) for j in range(last)] + [(0, last)]
    idx_last_real = jnp.asarray(
        [max(r - 1, 0) for r in n_real], dtype=jnp.int32
    )
    n_real_arr = jnp.asarray(n_real, dtype=jnp.int32)
    omega = float(params.omega)
    w1 = float(params.accel_w1)
    w2 = float(params.accel_w2)
    free_inv = jnp.float32(params.free_cells_inv)
    accel_glob = params.accel_row
    rest = jnp.asarray(WEIGHTS * np.float32(params.density))

    def body(f_loc, obst_loc):
        d = jax.lax.axis_index(axis_name)
        accel_row_local = _local_accel_row(accel_glob, axis_name, rows)
        nr = n_real_arr[d]
        send_idx = idx_last_real[d]

        def one_step(f, _):
            f = step_local.accelerate_local(f, obst_loc, accel_row_local, w1, w2)
            last_real = jax.lax.dynamic_slice_in_dim(f, send_idx, 1, axis=1)
            halo_lo = jax.lax.ppermute(last_real[:, 0, :], axis_name, perm_fwd)
            halo_hi = jax.lax.ppermute(f[:, 0, :], axis_name, perm_bwd)
            ext = jnp.concatenate(
                [halo_lo[:, None, :], f, halo_hi[:, None, :]], axis=1
            )
            # Wrap row placed right after the last real row (a no-op for full
            # shards, where 1 + nr is already the bottom-halo slot).
            ext = jax.lax.dynamic_update_slice_in_dim(
                ext, halo_hi[:, None, :], 1 + nr, axis=1
            )
            t = [
                jnp.roll(ext[k, 1 - CY[k] : 1 - CY[k] + rows, :], CX[k], axis=1)
                for k in range(NSPEEDS)
            ]
            out, speed = physics.collide(t, obst_loc, omega)
            return jnp.stack(out), jnp.sum(speed, dtype=jnp.float32) * free_inv

        f_out, av_local = jax.lax.scan(one_step, f_loc, None, length=n_steps)
        return f_out, jax.lax.psum(av_local, axis_name)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis_name, None), P(axis_name, None)),
        out_specs=(P(None, axis_name, None), P()),
        check_vma=False,
    )
    f_spec = NamedSharding(mesh, P(None, axis_name, None))
    o_spec = NamedSharding(mesh, P(axis_name, None))

    @functools.partial(jax.jit, donate_argnums=0)
    def runner(f, obstacles):
        # Dead rows: rest equilibrium (strictly positive, so densities stay
        # positive under pure bounce-back) and obstacle-masked.
        f_pad = jnp.concatenate(
            [f, jnp.broadcast_to(rest[:, None, None], (NSPEEDS, pad, nx))],
            axis=1,
        )
        obst_pad = jnp.pad(
            obstacles, ((0, pad), (0, 0)), constant_values=True
        )
        f_pad = jax.lax.with_sharding_constraint(f_pad, f_spec)
        obst_pad = jax.lax.with_sharding_constraint(obst_pad, o_spec)
        f_out, av = sharded(f_pad, obst_pad)
        return f_out[:, :ny, :], av

    return runner


def _make_runner_2d(params: LBMParams, n_steps: int, mesh: Mesh):
    """Runner over a 2-D ('y', 'x') torus mesh: both grid axes sharded, with
    a two-phase width-1 halo exchange per step (columns first, then rows of
    the column-extended block, so corner cells ride along) — the tiled
    decomposition the reference's report declined (report.odt "MPI Design").
    Pull-streaming needs no rolls at all because both wraps come from the
    ring permutations."""
    ay, ax = mesh.axis_names
    dy, dx = mesh.devices.shape
    h = validate_even_split(params.ny, dy)
    validate_even_col_split(params.nx, dx)

    free_inv = jnp.float32(params.free_cells_inv)
    accel_glob = params.accel_row
    omega = float(params.omega)
    w1 = float(params.accel_w1)
    w2 = float(params.accel_w2)
    perm = {
        a: (
            [(i, (i + 1) % n) for i in range(n)],
            [(i, (i - 1) % n) for i in range(n)],
        )
        for a, n in ((ay, dy), (ax, dx))
    }

    def body(f_loc, obst_loc):
        accel_row_local = _local_accel_row(accel_glob, ay, h)

        def one_step(f, _):
            f = step_local.accelerate_local(
                f, obst_loc, accel_row_local, w1, w2
            )
            # phase 1: x halo columns
            fwd, bwd = perm[ax]
            xlo = jax.lax.ppermute(f[:, :, -1:], ax, fwd)
            xhi = jax.lax.ppermute(f[:, :, :1], ax, bwd)
            fx = jnp.concatenate([xlo, f, xhi], axis=2)
            # phase 2: y halo rows of the x-extended block (corners included)
            fwd, bwd = perm[ay]
            ylo = jax.lax.ppermute(fx[:, -1:, :], ay, fwd)
            yhi = jax.lax.ppermute(fx[:, :1, :], ay, bwd)
            ext = jnp.concatenate([ylo, fx, yhi], axis=1)
            # pull-streaming by pure slicing — both wraps came off the rings
            hh, ww = f.shape[1], f.shape[2]
            t = [
                ext[k, 1 - CY[k] : 1 - CY[k] + hh,
                    1 - CX[k] : 1 - CX[k] + ww]
                for k in range(NSPEEDS)
            ]
            out, speed = physics.collide(t, obst_loc, omega)
            return jnp.stack(out), jnp.sum(speed, dtype=jnp.float32) * free_inv

        f_out, av_local = jax.lax.scan(one_step, f_loc, None, length=n_steps)
        av = jax.lax.psum(jax.lax.psum(av_local, ay), ax)
        return f_out, av

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, ay, ax), P(ay, ax)),
        out_specs=(P(None, ay, ax), P()),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=0)
    def runner(f, obstacles):
        return sharded(f, obstacles)

    return runner


def make_runner(
    params: LBMParams,
    n_steps: int,
    mesh: Optional[Mesh] = None,
    axis_name: str = AXIS,
) -> Callable:
    """Builds a jitted ``runner(f, obstacles) -> (f', av_vels)``.

    ``f`` is the global (9, ny, nx) float32 state (sharded or not — jit will
    respect/install the row sharding), ``obstacles`` the global (ny, nx) bool
    mask. ``av_vels`` is the (n_steps,) float32 series, fully reduced.
    The runner donates ``f``.

    A 2-D mesh (two axis names) selects the torus decomposition — both grid
    axes sharded. On a 1-D mesh, ``ny`` that does not split evenly into
    >= 3-row shards takes the padded ring.
    """
    if mesh is None:
        mesh = get_mesh(axis_name=axis_name)
    if len(mesh.axis_names) == 2:
        return _make_runner_2d(params, n_steps, mesh)
    n_dev = mesh.devices.size
    if params.ny % n_dev != 0 or params.ny // n_dev < 3:
        if n_dev == 1:
            # ny < 3 on one device is physically degenerate; keep the error.
            validate_even_split(params.ny, n_dev)
        return _make_padded_runner(params, n_steps, mesh, axis_name)
    return _make_ring_runner(params, n_steps, mesh, axis_name)
