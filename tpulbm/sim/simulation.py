"""High-level simulation driver.

Owns the lifecycle the reference's ``main`` drives by hand
(d2q9-bgk.c:153-440): initialise from a parameter deck + obstacle file, run
the step loop (in jitted chunks so checkpointing and progress reporting are
possible mid-run — a subsystem the reference lacks entirely), then expose the
final state, the av_vels series and the Reynolds number.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from tpulbm.core.params import LBMParams
from tpulbm.core.state import initial_state
from tpulbm.diag.observables import av_velocity, calc_reynolds
from tpulbm.dist.mesh import get_mesh
from tpulbm.dist.runner import make_runner
from tpulbm.dist.sharding import shard_arrays
from tpulbm.io.obstacles import read_obstacles
from tpulbm.io.params_file import read_params
from tpulbm.io.writers import write_av_vels, write_final_state
from tpulbm.sim import checkpoint as ckpt


@dataclasses.dataclass
class SimulationResult:
    params: LBMParams
    f: jnp.ndarray
    av_vels: np.ndarray
    reynolds: float
    elapsed_s: float


class Simulation:
    def __init__(
        self,
        params: LBMParams,
        obstacles: np.ndarray,
        mesh: Optional[Mesh] = None,
        ckpt_backend: str = "npz",
    ):
        if params.free_cells_inv == 0.0:
            params = params.with_free_cells(
                params.nx * params.ny - int(np.asarray(obstacles).sum())
            )
        self.params = params
        self.mesh = mesh if mesh is not None else get_mesh(n_devices=None)
        from tpulbm.dist.sharding import (
            validate_even_col_split,
            validate_even_split,
        )

        if len(self.mesh.axis_names) == 2:
            dy, dx = self.mesh.devices.shape
            validate_even_split(params.ny, dy)
            validate_even_col_split(params.nx, dx)
        # 1-D meshes accept any (ny, n_devices): uneven shapes route to the
        # padded masked-dead-rows runner (dist/runner._make_padded_runner).
        obst = jnp.asarray(np.asarray(obstacles, dtype=bool))
        f = initial_state(params)
        self.f, self.obstacles = shard_arrays(self.mesh, f, obst)
        self.step_count = 0
        self.av_vels = np.zeros((params.max_iters,), dtype=np.float32)
        self._runners = {}
        self.ckpt_backend = ckpt_backend
        self._async_ckpt = ckpt.AsyncCheckpointer(backend=ckpt_backend)

    @classmethod
    def from_files(
        cls,
        param_file: str | os.PathLike,
        obstacle_file: str | os.PathLike,
        mesh: Optional[Mesh] = None,
        ckpt_backend: str = "npz",
    ) -> "Simulation":
        params = read_params(param_file)
        mask, num_free = read_obstacles(obstacle_file, params.nx, params.ny)
        return cls(params.with_free_cells(num_free), mask, mesh=mesh,
                   ckpt_backend=ckpt_backend)

    def settle(self) -> None:
        """Wait for the host->device uploads of the state/obstacles. The
        reference's tic starts after ``initialise`` with the grids fully
        resident (d2q9-bgk.c:278-279); without this the asynchronous upload
        rides inside the CLI's timed region."""
        jax.block_until_ready((self.f, self.obstacles))

    def _runner(self, n_steps: int):
        # Each distinct size compiles its own jitted scan (several minutes at
        # 4096^2 scale), so run() plans chunk sizes with _plan_chunks to keep
        # the count at <= 2 per run (main + one remainder); the cache makes
        # repeated sizes free across run() calls.
        key = n_steps
        if key not in self._runners:
            self._runners[key] = make_runner(
                self.params, n_steps, mesh=self.mesh
            )
        return self._runners[key]

    @staticmethod
    def _plan_chunks(start: int, total: int, chunk: int,
                     cadence: Optional[int]) -> list:
        """Chunk sizes covering ``[start, start + total)`` such that every
        multiple of ``cadence`` inside the range ends a chunk (so periodic
        checkpoints actually fire, including after a mid-cadence resume).

        Compile-cost guarantee: at most two distinct sizes (the main chunk +
        one remainder) when ``start`` sits on a cadence boundary — the fresh-
        run case — so at most two runner compiles per run. A mid-cadence
        resume adds one alignment head (a third size) to restore the cadence.
        """
        sizes = []
        pos = start
        end = start + total
        if cadence:
            head = min((-pos) % cadence, end - pos)
            if head:
                sizes.append(min(head, chunk))
                pos += sizes[-1]
        while pos < end:
            n = min(chunk, end - pos)
            if cadence:
                n = min(n, (-pos) % cadence or cadence)
            sizes.append(n)
            pos += n
        return sizes

    def run(
        self,
        n_steps: Optional[int] = None,
        chunk: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        progress: bool = False,
        debug: bool = False,
        metrics_file: Optional[str] = None,
    ) -> SimulationResult:
        """Advance ``n_steps`` (default: the deck's maxIters minus steps
        already taken), returning the accumulated result."""
        remaining = self.params.max_iters - self.step_count
        total = remaining if n_steps is None else n_steps
        if total > remaining:
            raise ValueError(
                f"run of {total} steps would exceed the deck's maxIters="
                f"{self.params.max_iters} (already at step {self.step_count})"
            )
        if checkpoint_every and not checkpoint_dir:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        if chunk is None:
            chunk = total if checkpoint_every is None else checkpoint_every
            if metrics_file and chunk == total:
                chunk = max(1, min(total, 1000))
        chunk = max(1, min(chunk, total))
        if metrics_file:
            parent = os.path.dirname(metrics_file)
            if parent:
                os.makedirs(parent, exist_ok=True)
        metrics_fp = open(metrics_file, "a") if metrics_file else None
        plan = self._plan_chunks(
            self.step_count, total, chunk, checkpoint_every
        )
        t0 = time.perf_counter()
        done = 0
        try:
            for n in plan:
                runner = self._runner(n)
                self.f, av = runner(self.f, self.obstacles)
                av_np = np.asarray(av)
                if not np.isfinite(av_np[-1]):
                    # Divergence check — the runtime equivalent of the
                    # reference's disabled feenableexcept FP traps
                    # (d2q9-bgk.c:60,195). BGK goes unstable for omega near 2
                    # or too-strong forcing. Bookkeeping is advanced through
                    # the last finite step first so the object stays
                    # consistent for callers that catch and inspect (the
                    # in-memory state itself is past the divergence — the
                    # pre-chunk state was donated and cannot be restored).
                    bad = int(np.argmax(~np.isfinite(av_np)))
                    self.av_vels[self.step_count : self.step_count + bad] = (
                        av_np[:bad]
                    )
                    self.step_count += bad
                    raise FloatingPointError(
                        f"simulation diverged (non-finite average velocity "
                        f"at step {self.step_count}); check omega "
                        f"({self.params.omega}) and accel "
                        f"({self.params.accel})"
                    )
                lo = self.step_count
                self.av_vels[lo : lo + n] = av_np
                self.step_count += n
                done += n
                if progress:
                    print(
                        f"step {self.step_count}/{self.params.max_iters} "
                        f"av_vel={av_np[-1]:.6E}",
                        flush=True,
                    )
                if debug:
                    # The reference's DEBUG block (d2q9-bgk.c:380-393).
                    from tpulbm.diag.observables import total_density

                    print(f"==timestep: {self.step_count - 1}==")
                    print(f"av velocity: {av_np[-1]:.12E}")
                    print(
                        f"tot density: {float(total_density(self.f)):.12E}",
                        flush=True,
                    )
                if metrics_fp is not None:
                    import json

                    wall = max(time.perf_counter() - t0, 1e-9)
                    metrics_fp.write(json.dumps({
                        "step": self.step_count,
                        "av_vel": float(av_np[-1]),
                        "wall_s": round(wall, 4),
                        # this run's steps over this run's wall time
                        "steps_per_s": round(done / wall, 2),
                    }) + "\n")
                    metrics_fp.flush()
                if checkpoint_every and checkpoint_dir and (
                    self.step_count % checkpoint_every == 0
                    or done >= total
                ):
                    # async: serialization overlaps the next compute chunk
                    self._async_ckpt.submit(
                        checkpoint_dir, self.step_count, self.f, self.av_vels,
                        self.params,
                    )
        finally:
            # join the in-flight checkpoint (surfacing its errors) and flush
            # metrics even when a chunk raised
            try:
                self._async_ckpt.wait()
            except Exception as ckpt_err:
                import sys

                if sys.exc_info()[1] is None:
                    raise
                # don't mask the in-flight exception with the write failure
                print(f"warning: async checkpoint failed: {ckpt_err}",
                      file=sys.stderr)
            if metrics_fp is not None:
                metrics_fp.close()
        jax.block_until_ready(self.f)
        elapsed = time.perf_counter() - t0
        reyn = float(calc_reynolds(self.f, self.obstacles, self.params))
        return SimulationResult(
            params=self.params,
            f=self.f,
            av_vels=self.av_vels[: self.step_count].copy(),
            reynolds=reyn,
            elapsed_s=elapsed,
        )

    # -- observables ------------------------------------------------------
    def reynolds(self) -> float:
        return float(calc_reynolds(self.f, self.obstacles, self.params))

    def average_velocity(self) -> float:
        return float(av_velocity(self.f, self.obstacles, self.params))

    # -- persistence ------------------------------------------------------
    def write_outputs(self, out_dir: str | os.PathLike = ".") -> None:
        """Write final_state.dat + av_vels.dat.

        Multi-host aware: each process contributes its shard via one gather
        and process 0 writes (the analog of the reference's rank-ordered
        sequential append, d2q9-bgk.c:1049-1122); other processes return
        after participating in the collective."""
        from tpulbm.diag.observables import output_fields
        from tpulbm.dist.multihost import gather_to_host, is_output_process

        fields = output_fields(self.f, self.obstacles, self.params.density)
        fields = [gather_to_host(a) for a in fields]
        obst = gather_to_host(self.obstacles)
        if not is_output_process():
            return
        os.makedirs(out_dir, exist_ok=True)
        write_final_state(
            os.path.join(out_dir, "final_state.dat"),
            None,
            np.asarray(obst),
            self.params,
            fields=fields,
        )
        write_av_vels(
            os.path.join(out_dir, "av_vels.dat"), self.av_vels[: self.step_count]
        )

    def save_checkpoint(self, directory: str | os.PathLike) -> str:
        return ckpt.save(
            directory,
            step=self.step_count,
            f=self.f if self.ckpt_backend == "orbax" else np.asarray(self.f),
            av_vels=self.av_vels,
            params=self.params,
            backend=self.ckpt_backend,
        )

    def restore_checkpoint(self, path_or_dir: str | os.PathLike) -> None:
        abstract_f = None
        if (
            len(self.mesh.axis_names) != 1
            or self.params.ny % self.mesh.devices.size == 0
        ):
            # Sharding-aware orbax restore: shards land straight on the mesh
            # (multi-host: each process reads only its own) with no host
            # full-array materialization. npz paths ignore the target — they
            # are host-gathered by construction. Uneven-ny 1-D meshes keep
            # the host path (the padded runner installs sharding inside jit).
            from tpulbm.dist.sharding import row_sharding

            state_s, _ = row_sharding(self.mesh)
            abstract_f = jax.ShapeDtypeStruct(
                (9, self.params.ny, self.params.nx), jnp.float32,
                sharding=state_s,
            )
        step, f, av_vels = ckpt.restore(
            path_or_dir, self.params, abstract_f=abstract_f
        )
        self.step_count = step
        self.av_vels[: av_vels.size] = av_vels[: self.av_vels.size]
        if isinstance(f, jax.Array) and f.sharding is not None and (
            abstract_f is not None
        ):
            self.f = f  # already placed by the sharded restore
        else:
            f_arr, _ = shard_arrays(self.mesh, jnp.asarray(f), self.obstacles)
            self.f = f_arr
