"""The per-layer metrics' readers on a made-up trace: each reads what its
file says, and a trace with nothing to read gives nothing."""

import pytest
from conftest import benchmark_json

from benchlib import spec, trace

MS = 1_000_000  # ns


def _trace(device_ops, launches=(), host_ops=(), replays=2):
    return trace.Trace(replays=replays, seeds=1, wall_s=10e-3, enqueue_s=0.3e-3,
                       device_ops=list(device_ops),
                       launches=list(launches), host_ops=list(host_ops),
                       entry_bytes={"bitmap_fit_rounds": 335_000, "utility_topk_address": 0,
                                    "zone_aggregate_members": 0, "survival_scan": 0},
                       tick_bytes=3_350_000, peak_bytes_per_s=3.35e12)


OPS = [
    ("void at::native::elementwise_kernel<128, 4>(int, ...)", "kernel", 0, 2 * MS),
    ("void (anonymous namespace)::bitmap_fit_rounds_kernel<1>(...)", "kernel", 1 * MS, 1 * MS),
    ("Memcpy DtoD (Device -> Device)", "memcpy", 4 * MS, 1 * MS),
    ("void at::native::elementwise_kernel<128, 4>(int, ...)", "kernel", 6 * MS, 2 * MS),
    ("void (anonymous namespace)::bitmap_fit_rounds_kernel<1>(...)", "kernel", 7 * MS, 1 * MS),
]


def _read(name, tr):
    return spec.reader(name)(tr)


def test_busy_time_is_the_union_of_the_device_intervals():
    tr = _trace(OPS)
    assert tr.busy_intervals() == [(0, 2 * MS), (4 * MS, 5 * MS), (6 * MS, 8 * MS)]
    assert tr.busy_s() == pytest.approx(5e-3)
    assert _read("device.idle_pct", tr) == pytest.approx(50.0)


def test_the_readers_read_what_their_files_say():
    tr = _trace(OPS, launches=[(0, 10), (3 * MS, 20), (5 * MS, 10)])
    assert _read("scan.copy_ms", tr) == pytest.approx(0.5)
    assert _read("tick.plain_ms", tr) == pytest.approx(2.0)
    assert _read("kernels.ms", tr) == pytest.approx(1.0)
    assert _read("tick.kernels", tr) == 2
    assert _read("scan.enqueue_ms", tr) == pytest.approx(0.15)
    # two launches of 335 kB at 3.35 TB/s = 0.2 us against 2 ms of kernel time
    assert _read("kernels_roofline", tr) == pytest.approx(0.01)
    # a replay: 1 us least against 2.5 ms busy
    assert _read("device.bound_pct", tr) == pytest.approx(0.04)


@pytest.mark.parametrize("name", [m["name"] for m in benchmark_json()["per_layer"]])
def test_a_trace_without_device_work_reads_nothing(name):
    assert _read(name, _trace([])) is None


def test_the_breakdown_names_the_host_event_in_each_gap():
    tr = _trace(OPS, host_ops=[("aten::copy_", 2 * MS, 2 * MS), ("outer", 0, 10 * MS)])
    b = tr.breakdown()
    assert b["device_ops"][0] == [OPS[0][0], 4e-3]
    assert b["idle_gaps"] == [["aten::copy_", 2e-3], ["outer", 1e-3]]
