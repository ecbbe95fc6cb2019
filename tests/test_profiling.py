"""The reduction from a device trace to per-step metrics.

The fixture is the GPU device plane of a recorded ``jax.profiler`` trace:
20 steps of the XLA step at 1024x1024 on one H100, stored as an XSpace
text proto, plus one host plane that must be ignored.
"""

import os

import pytest
from jax.profiler import ProfileData

from tpulbm.utils import profiling

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "h100_step_trace_1024.pbtxt")
STEPS = 20
# the 13 kernels XLA launches each step in the recorded trace
STEP_KERNELS = {
    "loop_concatenate_fusion", "memcpy128", "input_concatenate_fusion",
    "input_reduce_subtract_fusion", "input_concatenate_fusion_1",
    "input_concatenate_fusion_2", "input_concatenate_fusion_3",
    "input_concatenate_fusion_4", "input_concatenate_fusion_5",
    "input_concatenate_fusion_6", "input_reduce_fusion",
    "loop_dynamic_update_slice_fusion", "loop_add_fusion",
}


@pytest.fixture(scope="module")
def recorded():
    with open(FIXTURE) as fh:
        return ProfileData.from_text_proto(fh.read())


def test_only_gpu_plane_events_are_kernels(recorded):
    events = profiling.gpu_kernel_events(recorded)
    assert len(events) == 262  # 13 per step and two one-off kernels
    assert "PjitFunction(runner)" not in {e[0] for e in events}
    starts = [e[1] for e in events]
    assert starts == sorted(starts)


def test_kernel_summary_per_step(recorded):
    s = profiling.kernel_summary(profiling.gpu_kernel_events(recorded), STEPS)
    assert s["kernels_per_step"] == pytest.approx(262 / STEPS)
    per_step = {n for n, k in s["by_name"].items() if k["per_step"] == 1.0}
    assert per_step == STEP_KERNELS
    # one stream: the recorded kernels overlap by at most a few timer ticks
    assert s["busy_us_per_step"] <= s["device_us_per_step"]
    assert s["busy_us_per_step"] == pytest.approx(s["device_us_per_step"],
                                                  rel=0.01)
    assert 100.0 < s["device_us_per_step"] < 200.0
    assert 0.0 <= s["idle_share"] < 1.0
    times = [k["us_per_step"] for k in s["by_name"].values()]
    assert times == sorted(times, reverse=True)
    assert next(iter(s["by_name"])) == "loop_concatenate_fusion"


def test_kernel_summary_overlap_and_idle():
    # two overlapping kernels [0, 10) and [5, 15), then a gap, then [20, 30)
    events = [("a", 0, 10), ("b", 5, 10), ("a", 20, 10)]
    s = profiling.kernel_summary(events, 1)
    assert s["device_us_per_step"] == pytest.approx(30e-3)
    assert s["busy_us_per_step"] == pytest.approx(25e-3)
    assert s["idle_share"] == pytest.approx(5 / 30)
    assert s["by_name"]["a"] == {"per_step": 2.0, "us_per_step": 20e-3}


def test_trace_without_gpu_plane_is_an_error():
    host_only = ProfileData.from_text_proto(
        'planes { id: 1 name: "/host:CPU" lines { id: 1 name: "python" '
        'events { metadata_id: 1 duration_ps: 5 } } '
        'event_metadata { key: 1 value { id: 1 name: "x" } } }')
    with pytest.raises(ValueError, match="no GPU kernel events"):
        profiling.gpu_kernel_events(host_only)


def test_read_trace_missing_is_an_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.read_trace(str(tmp_path))


def test_implied_bytes_per_cell_step():
    # at the published 3.35 TB/s, 72 B/cell over 2^20 cells take ~22.5 us
    us = 72 * 2**20 / 3.35e12 * 1e6
    got = profiling.implied_bytes_per_cell_step(
        us, 2**20, "NVIDIA H100 80GB HBM3")
    assert got == pytest.approx(profiling.MIN_BYTES_PER_CELL_STEP)
    with pytest.raises(KeyError):
        profiling.implied_bytes_per_cell_step(us, 2**20, "cpu")
