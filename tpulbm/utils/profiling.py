"""Profiling hooks and the reduction from a device trace to step metrics.

Equivalent of the reference's two profiling generations (TAU flat
profiles and Intel ITAC `MPI_Pcontrol(±1,"mainloop")` brackets,
d2q9-bgk.c:275-277,404-406): a `jax.profiler` trace scoped to the step loop,
viewable in Perfetto, xprof or TensorBoard.

The reduction reads the ``.xplane.pb`` that ``jax.profiler.trace`` writes,
with ``jax.profiler.ProfileData``. Kernels are the events on the planes named
``/device:GPU:<n>``; host planes are ignored. A trace without such a plane
is an error, never a missing number.
"""

from __future__ import annotations

import contextlib
import glob
import os
import subprocess
from typing import Optional

import jax

GPU_PLANE_PREFIX = "/device:GPU:"

# Published HBM bandwidth by ``device_kind`` (NVIDIA H100 SXM data sheet).
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# A one-pass D2Q9 float32 step reads and writes nine populations per cell.
MIN_BYTES_PER_CELL_STEP = 2 * 9 * 4


@contextlib.contextmanager
def trace_region(name: str, trace_dir: Optional[str] = None):
    """Scope a named trace region; if trace_dir is set, capture a full
    profiler trace of the region (the `make profile` equivalent)."""
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            with jax.profiler.TraceAnnotation(name):
                yield
    else:
        with jax.profiler.TraceAnnotation(name):
            yield


def read_trace(trace_dir: str):
    """The newest ``.xplane.pb`` under ``trace_dir`` as ProfileData."""
    files = glob.glob(
        os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")
    )
    if not files:
        raise FileNotFoundError(f"no .xplane.pb trace under {trace_dir}")
    return jax.profiler.ProfileData.from_file(max(files, key=os.path.getmtime))


def gpu_kernel_events(profile) -> list:
    """(name, start_ns, duration_ns) of every event on the GPU device
    planes, sorted by start."""
    events = [
        (e.name, e.start_ns, e.duration_ns)
        for plane in profile.planes
        if plane.name.startswith(GPU_PLANE_PREFIX)
        for line in plane.lines
        for e in line.events
    ]
    if not events:
        names = [p.name for p in profile.planes]
        raise ValueError(f"trace holds no GPU kernel events (planes: {names})")
    return sorted(events, key=lambda e: e[1])


def kernel_summary(events, n_steps: int) -> dict:
    """Per-step view of a traced window of ``n_steps`` steps.

    ``device_us_per_step`` sums kernel durations; ``busy_us_per_step`` is
    the union of their intervals (the two differ only where kernels
    overlap); ``idle_share`` is 1 - busy over the window from the first
    kernel's start to the last one's end. ``by_name`` gives each kernel's
    launches and µs per step, slowest first.
    """
    by_name = {}
    for name, _, dur in events:
        c, t = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, t + dur)
    busy = 0.0
    cur_start = cur_end = None
    for _, start, dur in events:
        end = start + dur
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(s + d for _, s, d in events) - events[0][1]
    return {
        "kernels_per_step": len(events) / n_steps,
        "device_us_per_step": sum(d for _, _, d in events) / n_steps / 1e3,
        "busy_us_per_step": busy / n_steps / 1e3,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "by_name": {
            name: {"per_step": c / n_steps, "us_per_step": t / n_steps / 1e3}
            for name, (c, t) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])
        },
    }


def implied_bytes_per_cell_step(device_us_per_step: float, cells: int,
                                 device_kind: str) -> float:
    """Bytes per cell-step the step would move if its device time were
    spent at the card's published HBM bandwidth; compare with
    ``MIN_BYTES_PER_CELL_STEP``. An unknown ``device_kind`` is an error."""
    if device_kind not in HBM_BYTES_PER_S:
        raise KeyError(f"no published HBM bandwidth for {device_kind!r}")
    return device_us_per_step * 1e-6 * HBM_BYTES_PER_S[device_kind] / cells


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
