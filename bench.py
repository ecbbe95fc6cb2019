#!/usr/bin/env python
"""Step-loop benchmark on one NVIDIA GPU: MLUPS of a shipped deck.

    python bench.py [--grid 1024x1024]

Runs the deck's full step count through ``make_runner`` on one card:
compile (reported as set-up), three timed runs that end in a readback
(best kept), then a short run of its own under the profiler, reduced to
device µs and kernels per step (``tpulbm.utils.profiling``).

Baseline: the reference's best times (BASELINE.md; 64 Xeon cores, e.g.
5.92 s for 20000 steps of 1024x1024, report.odt table 4).
``vs_baseline`` is the speedup over that deck's reference MLUPS.

Diagnostics go to stderr; the last line on stdout is one JSON object naming
the device. Without a GPU it exits non-zero and measures nothing.
"""

import argparse
import json
import os
import sys
import tempfile
import time

REPS = 3
TRACE_STEPS = 20

# Reference best-build times per deck (BASELINE.md): grid -> (seconds, iters)
REFERENCE_BEST = {
    "128x128": (0.525, 40000),
    "128x256": (0.639, 40000),
    "256x256": (2.705, 80000),
    "1024x1024": (5.922, 20000),
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", default="1024x1024",
                    help="shipped deck, data/input_<grid>.params")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py: needs an NVIDIA GPU; JAX found {dev.platform}")
        return 1

    from tpulbm.core.state import initial_state
    from tpulbm.dist.mesh import get_mesh
    from tpulbm.dist.runner import make_runner
    from tpulbm.io.obstacles import read_obstacles
    from tpulbm.io.params_file import read_params
    from tpulbm.utils import profiling
    from tpulbm.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    card = profiling.card_name_and_power_limit()
    log(f"platform={dev.platform} device_kind={dev.device_kind} "
        f"devices={len(jax.devices())} nvidia-smi: {card}")

    params = read_params(f"data/input_{args.grid}.params")
    mask, num_free = read_obstacles(f"data/obstacles_{args.grid}.dat",
                                    params.nx, params.ny)
    params = params.with_free_cells(num_free)
    obst = jax.numpy.asarray(mask)
    n_steps = params.max_iters
    cells = params.nx * params.ny
    mesh = get_mesh(n_devices=1)

    t0 = time.perf_counter()
    runner = make_runner(params, n_steps, mesh=mesh)
    f = initial_state(params)
    compiled = runner.lower(f, obst).compile()
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(REPS):
        f = jax.block_until_ready(initial_state(params))
        t0 = time.perf_counter()
        f, av = compiled(f, obst)
        av = np.asarray(av)
        walls.append(time.perf_counter() - t0)
        if not np.all(np.isfinite(av)):
            raise FloatingPointError("non-finite av_vels in the timed run")
    best = min(walls)
    log(f"compile {compile_s:.3f} s; walls {walls}")

    traced = make_runner(params, TRACE_STEPS, mesh=mesh)
    g = jax.block_until_ready(traced(initial_state(params), obst)[0])
    with tempfile.TemporaryDirectory() as trace_dir:
        with jax.profiler.trace(trace_dir):
            g, av_k = traced(g, obst)
            jax.block_until_ready((g, av_k))
        summary = profiling.kernel_summary(
            profiling.gpu_kernel_events(profiling.read_trace(trace_dir)),
            TRACE_STEPS)
    log(json.dumps(summary["by_name"]))

    mlups = cells * n_steps / best / 1e6
    ref = REFERENCE_BEST.get(args.grid)
    out = {
        "metric": f"mlups_{args.grid}_{n_steps}steps",
        "value": mlups,
        "unit": "MLUPS",
        "wall_s": best,
        "compile_s": compile_s,
        "device_us_per_step": summary["device_us_per_step"],
        "kernels_per_step": summary["kernels_per_step"],
        "idle_share": summary["idle_share"],
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }
    if ref:
        out["vs_baseline"] = mlups / (cells * ref[1] / ref[0] / 1e6)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
