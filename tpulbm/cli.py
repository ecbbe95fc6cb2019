"""Command-line entry point.

Drop-in equivalent of the reference binary's CLI (d2q9-bgk.c:153-440,
1153-1157):

    python -m tpulbm <paramfile> <obstaclefile> [options]

prints the same result block (Reynolds number, wall/user/system time —
d2q9-bgk.c:409-416) and writes reference-format final_state.dat and
av_vels.dat into --out-dir.
"""

from __future__ import annotations

import argparse
import resource
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpulbm",
        description="D2Q9-BGK lattice-Boltzmann solver (JAX)",
    )
    p.add_argument("paramfile")
    p.add_argument("obstaclefile")
    p.add_argument("--out-dir", default=".", help="output directory")
    p.add_argument(
        "--device-count",
        type=int,
        default=None,
        help="number of devices in the 1-D mesh (default: all)",
    )
    p.add_argument(
        "--mesh-shape",
        default=None,
        metavar="DYxDX",
        help="2-D torus mesh: shard BOTH grid axes, e.g. 2x4 "
             "(overrides --device-count)",
    )
    p.add_argument(
        "--multihost",
        action="store_true",
        help="initialize jax.distributed (one process per host; "
             "TPULBM_COORDINATOR/TPULBM_NUM_PROCS/TPULBM_PROC_ID env, or "
             "what jax.distributed detects by itself) and run over the global "
             "host-contiguous device ring; process 0 writes outputs. "
             "See scripts/launch_multihost.sh",
    )
    p.add_argument(
        "--max-iters", type=int, default=None, help="override deck maxIters"
    )
    p.add_argument(
        "--chunk", type=int, default=None, help="steps per jitted scan chunk"
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=None,
        help="save a checkpoint every N steps",
    )
    p.add_argument(
        "--checkpoint-dir", default=None, help="checkpoint directory"
    )
    p.add_argument(
        "--ckpt-backend", choices=("npz", "orbax"), default="npz",
        help="checkpoint storage: npz (single atomic file) or orbax "
             "(async sharded save; each process writes its own shards "
             "on a multi-host mesh)",
    )
    p.add_argument(
        "--resume", default=None,
        help="checkpoint file or directory to resume from",
    )
    p.add_argument(
        "--profile-dir", default=None,
        help="capture a jax.profiler trace of the step loop into this dir",
    )
    p.add_argument("--progress", action="store_true")
    p.add_argument(
        "--no-output", action="store_true",
        help="skip writing final_state.dat/av_vels.dat (like PROFILE builds "
             "of the reference, d2q9-bgk.c:419-421)",
    )
    p.add_argument(
        "--metrics-file", default=None,
        help="append one JSON line per chunk (step, av_vel, wall time, "
             "throughput) — live observability for dashboards",
    )
    p.add_argument(
        "--debug", action="store_true",
        help="print av_velocity and total_density each chunk (the reference's "
             "DEBUG block, d2q9-bgk.c:380-393)",
    )
    return p


def die(message: str) -> "int":
    """Reference-style fatal error (d2q9-bgk.c:1145-1151): one clean line on
    stderr, exit status 1 — no traceback."""
    print(f"Error: {message}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import dataclasses

    from tpulbm.dist.mesh import get_mesh
    from tpulbm.io.obstacles import ObstacleFileError
    from tpulbm.io.params_file import ParamFileError
    from tpulbm.sim.simulation import Simulation
    from tpulbm.utils.cache import enable_compilation_cache
    from tpulbm.utils.profiling import trace_region

    enable_compilation_cache()
    if args.multihost:
        from tpulbm.dist.multihost import init_distributed, process_mesh_info

        try:
            init_distributed()
        except Exception as e:  # coordinator unreachable, bad env, ...
            return die(f"jax.distributed initialization failed: {e}")
        info = process_mesh_info()
        print(
            f"multihost: process {info['process_index']}/"
            f"{info['process_count']}, {info['local_devices']} local / "
            f"{info['global_devices']} global devices",
            file=sys.stderr,
        )
    try:
        if args.multihost and not args.mesh_shape and args.device_count is None:
            from tpulbm.dist.multihost import global_ring_mesh

            mesh = get_mesh(devices=list(global_ring_mesh().devices.flat))
        elif args.mesh_shape:
            from tpulbm.dist.mesh import get_mesh_2d

            dy, sep, dx = args.mesh_shape.partition("x")
            if not sep or not dy.isdigit() or not dx.isdigit():
                return die(
                    f"--mesh-shape must be DYxDX (e.g. 2x4), "
                    f"got {args.mesh_shape!r}"
                )
            mesh = get_mesh_2d(int(dy), int(dx))
        else:
            mesh = get_mesh(n_devices=args.device_count)
        sim = Simulation.from_files(
            args.paramfile, args.obstaclefile, mesh=mesh,
            ckpt_backend=args.ckpt_backend,
        )
    except FileNotFoundError as e:
        return die(f"could not open input file: {e.filename}")
    except (ParamFileError, ObstacleFileError, ValueError) as e:
        return die(str(e))
    if args.max_iters is not None:
        sim.params = dataclasses.replace(sim.params, max_iters=args.max_iters)
        import numpy as np

        sim.av_vels = np.zeros((args.max_iters,), dtype=np.float32)
    if args.resume:
        try:
            sim.restore_checkpoint(args.resume)
        except (FileNotFoundError, ValueError) as e:
            return die(f"cannot resume: {e}")

    # The reference starts its clock after initialise, grids resident
    # (d2q9-bgk.c:278-279); settle async uploads so the timed region is the
    # solve, not the host->device transfer.
    sim.settle()
    tic = time.time()
    try:
        with trace_region("mainloop", args.profile_dir):
            result = sim.run(
                chunk=args.chunk,
                checkpoint_every=args.checkpoint_every,
                checkpoint_dir=args.checkpoint_dir,
                progress=args.progress,
                debug=args.debug,
                metrics_file=args.metrics_file,
            )
    except ValueError as e:
        # e.g. shape/mesh mismatches surfaced lazily by make_runner
        return die(str(e))
    except FloatingPointError as e:
        return die(str(e))
    toc = time.time()
    ru = resource.getrusage(resource.RUSAGE_SELF)

    # Same result block as the reference MASTER rank (d2q9-bgk.c:409-416);
    # under --multihost only process 0 prints, like MASTER.
    from tpulbm.dist.multihost import is_output_process

    if not args.multihost or is_output_process():
        print("==done==")
        print("Reynolds number:\t\t%.12E" % result.reynolds)
        print("Elapsed time:\t\t\t%.6f (s)" % (toc - tic))
        print("Elapsed user CPU time:\t\t%.6f (s)" % ru.ru_utime)
        print("Elapsed system CPU time:\t%.6f (s)" % ru.ru_stime)

    if not args.no_output:
        sim.write_outputs(args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
