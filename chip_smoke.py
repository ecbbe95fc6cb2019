#!/usr/bin/env python
"""Smoke run of the solver on NVIDIA GPUs, in one process.

    python chip_smoke.py                # one card: phases (a) to (d)
    python chip_smoke.py --four-cards   # four cards: the ring and 2x2 runs

Phases on one card:

(a) the full 1024x1024 and 128x128 reference decks through ``cli.main``,
    gated against the shipped goldens at the reference's 1 % tolerance;
(b) ``make_runner`` against the plain reference ``step_jnp.run_steps`` at
    1024x1024 for 200 float32 steps;
(c) the 8192x8192 deck for 100 steps: memory analysis, peak memory, a
    finite |u| series and conserved mass;
(d) a short profiler trace of the step at 1024x1024 and 4096x4096: device
    kernels per step by name, device µs per step, and the bytes per
    cell-step that time implies at the card's HBM bandwidth.

With ``--four-cards`` it runs only the full 1024x1024 deck through
``cli.main`` on the 4-card ring (256 rows per card), on the 2x2 torus, and
on one card, and checks both 4-card runs against the goldens and against
the one-card |u| series.

Any failed phase raises, so the exit code is non-zero and no result line is
printed. The last line of standard output is one JSON object naming the
device as JAX reports it. Without a GPU the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data")
GOLDEN = os.path.join(REPO, "tests", "goldens")
OUT = os.path.join(REPO, "out", "chip_smoke")  # outputs and traces

# (b): the runner and the reference evaluate the same float32 expressions
# per cell; only the order of the |u| reduction may differ. The step has no
# matrix product, so TF32 does not apply.
RUNNER_AV_RTOL = 1e-5
RUNNER_F_ATOL = 1e-6
# --four-cards: psum over four partial |u| sums against one direct sum.
RING_AV_RTOL = 5e-5
# (c): float32 sums over 6e8 populations before and after.
MASS_RTOL = 1e-5
TRACE_STEPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def deck_paths(grid: str):
    return (os.path.join(DATA, f"input_{grid}.params"),
            os.path.join(DATA, f"obstacles_{grid}.dat"))


def load_deck(grid: str):
    import jax.numpy as jnp

    from tpulbm.io.obstacles import read_obstacles
    from tpulbm.io.params_file import read_params

    params_file, obstacle_file = deck_paths(grid)
    params = read_params(params_file)
    mask, num_free = read_obstacles(obstacle_file, params.nx, params.ny)
    return params.with_free_cells(num_free), jnp.asarray(mask)


def run_cli(grid: str, out_dir: str, *extra: str) -> None:
    from tpulbm.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main([*deck_paths(grid), "--out-dir", out_dir, *extra])
    assert rc == 0, f"cli.main {grid} {' '.join(extra)} exited {rc}"
    log(f"cli {grid} {' '.join(extra)}: wall incl. compile and output "
        f"{time.perf_counter() - t0:.3f} s")


def check_goldens(grid: str, out_dir: str) -> None:
    from tpulbm.validation.check import check_results

    ref_state = os.path.join(GOLDEN, f"{grid}.final_state.dat")
    if not os.path.exists(ref_state):
        ref_state = os.path.join(GOLDEN, f"{grid}.final_state.f64.npz")
    passed, av, fs = check_results(
        os.path.join(GOLDEN, f"{grid}.av_vels.dat"), ref_state,
        os.path.join(out_dir, "av_vels.dat"),
        os.path.join(out_dir, "final_state.dat"),
        tolerance=1.0, verbose=False,
    )
    log(f"golden {grid} vs {os.path.basename(ref_state)}: av_vels max "
        f"{av.max_diff_pcnt:+.4f} %, final_state max {fs.max_diff_pcnt:+.4f} %"
        f" -> {'pass' if passed else 'FAIL'} at 1 %")
    assert passed, f"golden check failed for {grid}"


def av_series(out_dir: str):
    import numpy as np

    return np.loadtxt(os.path.join(out_dir, "av_vels.dat"), usecols=[1])


def phase_cli(out_root: str) -> None:
    for grid in ("1024x1024", "128x128"):
        out = os.path.join(out_root, f"cli_{grid}")
        run_cli(grid, out)
        check_goldens(grid, out)


def phase_runner_vs_reference() -> None:
    import numpy as np

    from tpulbm.core.state import initial_state
    from tpulbm.dist.mesh import get_mesh
    from tpulbm.dist.runner import make_runner
    from tpulbm.ops.step_jnp import run_steps

    params, obst = load_deck("1024x1024")
    n = 200
    runner = make_runner(params, n, mesh=get_mesh(n_devices=1))
    f, av = runner(initial_state(params), obst)
    f_ref, av_ref = run_steps(initial_state(params), obst, params, n)
    f, av, f_ref, av_ref = map(np.asarray, (f, av, f_ref, av_ref))
    f_err = float(np.max(np.abs(f - f_ref)))
    av_err = float(np.max(np.abs(av - av_ref) / np.abs(av_ref)))
    log(f"runner vs step_jnp 1024x1024 x {n} steps: max |df| {f_err:.3e} "
        f"(atol {RUNNER_F_ATOL:g}), max rel d av {av_err:.3e} "
        f"(rtol {RUNNER_AV_RTOL:g}), bitwise {np.array_equal(f, f_ref)}")
    assert f_err <= RUNNER_F_ATOL and av_err <= RUNNER_AV_RTOL


def phase_largest_deck() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpulbm.core.state import initial_state
    from tpulbm.dist.mesh import get_mesh
    from tpulbm.dist.runner import make_runner

    params, obst = load_deck("8192x8192")
    n = 100
    runner = make_runner(params, n, mesh=get_mesh(n_devices=1))
    f = initial_state(params)
    mass0 = float(np.sum(np.asarray(jnp.sum(f, axis=(1, 2)), np.float64)))
    compiled = runner.lower(f, obst).compile()
    log(f"8192x8192 memory_analysis: {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    f, av = compiled(f, obst)
    av = np.asarray(av)
    wall = time.perf_counter() - t0
    mass = float(np.sum(np.asarray(jnp.sum(f, axis=(1, 2)), np.float64)))
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    log(f"8192x8192 x {n} steps: wall {wall:.3f} s, peak_bytes_in_use {peak}, "
        f"av finite {bool(np.all(np.isfinite(av)))}, av[-1] {av[-1]:.6e}, "
        f"mass rel change {abs(mass - mass0) / mass0:.3e} (rtol {MASS_RTOL:g})")
    assert av.shape == (n,) and np.all(np.isfinite(av)) and av[-1] > 0
    assert abs(mass - mass0) <= MASS_RTOL * mass0


def phase_step_trace(out_root: str) -> None:
    import jax

    from tpulbm.core.state import initial_state
    from tpulbm.dist.mesh import get_mesh
    from tpulbm.dist.runner import make_runner
    from tpulbm.utils import profiling

    kind = jax.devices()[0].device_kind
    for grid in ("1024x1024", "4096x4096"):
        params, obst = load_deck(grid)
        runner = make_runner(params, TRACE_STEPS, mesh=get_mesh(n_devices=1))
        f, _ = runner(initial_state(params), obst)  # compile outside the trace
        jax.block_until_ready(f)
        trace_dir = os.path.join(out_root, f"trace_{grid}")
        with jax.profiler.trace(trace_dir):
            f, av = runner(f, obst)
            jax.block_until_ready((f, av))
        s = profiling.kernel_summary(
            profiling.gpu_kernel_events(profiling.read_trace(trace_dir)),
            TRACE_STEPS,
        )
        cells = params.nx * params.ny
        bpc = profiling.implied_bytes_per_cell_step(
            s["device_us_per_step"], cells, kind)
        log(f"trace {grid} x {TRACE_STEPS} steps: "
            f"{s['kernels_per_step']:.2f} kernels/step, device "
            f"{s['device_us_per_step']:.2f} us/step, idle share "
            f"{s['idle_share']:.3f}, implied {bpc:.1f} B/cell-step at the "
            f"published HBM rate (floor "
            f"{profiling.MIN_BYTES_PER_CELL_STEP} B)")
        for name, k in s["by_name"].items():
            log(f"  {name}: {k['per_step']:.2f}/step, "
                f"{k['us_per_step']:.2f} us/step")


def phase_four_cards(out_root: str) -> None:
    import numpy as np

    grid = "1024x1024"
    one = os.path.join(out_root, "cards1")
    run_cli(grid, one, "--device-count", "1")
    av_one = av_series(one)
    for tag, extra in (("ring4", ("--device-count", "4")),
                       ("torus2x2", ("--mesh-shape", "2x2"))):
        out = os.path.join(out_root, tag)
        run_cli(grid, out, *extra)
        check_goldens(grid, out)
        av = av_series(out)
        rel = float(np.max(np.abs(av - av_one) / np.abs(av_one)))
        log(f"{tag} vs one card: max rel d av {rel:.3e} "
            f"(rtol {RING_AV_RTOL:g})")
        assert av.shape == av_one.shape and rel <= RING_AV_RTOL


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card ring and 2x2 torus phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    if args.four_cards and len(devices) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 1

    from tpulbm.utils.cache import enable_compilation_cache
    from tpulbm.utils.profiling import card_name_and_power_limit

    enable_compilation_cache()
    log(f"device_kind: {dev.device_kind}, devices: {len(devices)}")
    log(f"nvidia-smi name, power.limit: {card_name_and_power_limit()}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(OUT)
    else:
        phase_cli(OUT)
        phase_runner_vs_reference()
        phase_largest_deck()
        phase_step_trace(OUT)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
