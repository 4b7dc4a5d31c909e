"""The tick's stages on a made-up profile (``benchlib.stages``): each
replay's graph operations go to the stage map's nodes in order, the rest to
the span of the host call that launched them, and a replay that does not
match the map attributes nothing."""

import pytest

from benchlib import stages, trace

US = 1_000  # ns

MAP = [("kernel", "scan.draws"),
       ("kernel", "tick.survival/hotpath.survival_scan"),
       ("kernel", "tick.admission/da.address/hotpath.utility_topk_address"),
       ("kernel", "tick.admission"),
       ("memcpy", "scan.copyback")]
SPANS = [("scan.run", 0, 1000 * US), ("scan.load", 0, 10 * US),
         ("scan.replays", 10 * US, 900 * US), ("scan.unload", 910 * US, 90 * US)]


def _events(replays=2, drop=None, swap=None, as_kind="memset"):
    """A load copy, then each replay: two prologue fills and the graph's
    five operations, then an unload copy; ``drop`` = (replay, op) leaves an
    operation out, ``swap`` = (replay, op) makes it an ``as_kind``."""
    ops = [("Memcpy DtoD", "memcpy", 1 * US, 2 * US, 1)]
    calls = {1: 0}
    launches = []
    t = 20 * US
    for r in range(replays):
        base = 100 * (r + 1)
        for f in range(2):  # the replay prologue: a generator's seed and offset
            calls[base + f] = t
            ops.append(("fill", "kernel", t + 5 * US, 1 * US, base + f))
            t += 2 * US
        calls[base + 9] = t
        launches.append((t, 3 * US, base + 9))
        for n, (kind, _) in enumerate(MAP):
            if drop == (r, n):
                continue
            k = as_kind if swap == (r, n) else kind
            ops.append((f"{k} op {n}", k, t + (10 + n) * US, (n + 1) * US, base + 9))
        t += 40 * US
    calls[2] = 920 * US
    ops.append(("Memcpy DtoD", "memcpy", 990 * US, 4 * US, 2))
    return stages.Events(device_ops=ops, graph_launches=launches, calls=calls, spans=SPANS)


def test_each_replay_goes_to_the_map_node_by_node():
    att, why = stages.attribute(MAP, _events())
    assert why is None
    assert att.replays == 2
    # node n takes (n + 1) us a replay
    assert att.stage_ms("scan.draws") == pytest.approx(0.001)
    assert att.stage_ms("tick.survival") == pytest.approx(0.002)
    assert att.stage_ms("tick.admission") == pytest.approx(0.003 + 0.004)
    assert att.stage_ms("scan.copyback") == pytest.approx(0.005)
    assert att.stage_ms("tick.disruption") is None
    assert att.named_ms("op 2") == {"tick.admission": pytest.approx(0.003)}
    assert att.graph_ns() == 2 * 15 * US
    assert att.outside == {"scan.load": 2 * US, "scan.replays": 4 * US, "scan.unload": 4 * US}
    rows = att.table()
    assert [r[0] for r in rows] == [p for _, p in MAP] + [
        "outside the graph: scan.load", "replay prologue", "outside the graph: scan.unload"]
    assert rows[3] == ("tick.admission", pytest.approx(0.004), 1)
    assert rows[-2] == ("replay prologue", pytest.approx(0.002), -1)
    # the stage table and the rows outside the graph add up to every operation
    total = sum(op[3] for op in _events().device_ops)
    assert sum(r[1] for r in rows) * att.replays * 1e6 == pytest.approx(total)


def test_a_copy_node_may_run_as_a_kernel():
    # CUDA runs a graph's device-to-device copies as memcpy32_post kernels
    att, why = stages.attribute(MAP, _events(swap=(0, 4), as_kind="kernel"))
    assert why is None and att.stage_ms("scan.copyback") == pytest.approx(0.005)


def test_a_replay_that_does_not_match_the_map_attributes_nothing():
    att, why = stages.attribute(MAP, _events(drop=(1, 2)))
    assert att is None and why == "replay 1: 4 device operations against the map's 5 nodes"
    att, why = stages.attribute(MAP, _events(swap=(0, 4)))
    assert att is None and "operation 4 is a memset" in why
    att, why = stages.attribute(MAP, _events(swap=(1, 2), as_kind="memcpy"))
    assert att is None and why == "replay 1: operation 2 is a memcpy, the map's node a kernel"
    assert stages.attribute(None, _events()) == (None, "the compiled tick has no stage map")
    empty = stages.Events(device_ops=[], graph_launches=[], calls={}, spans=[])
    assert stages.attribute(MAP, empty)[0] is None


def test_unnamed_gaps_count_only_those_no_host_event_names():
    import stages as tool

    tr = trace.Trace(replays=1, seeds=1, wall_s=1e-3, enqueue_s=0.0,
                     device_ops=[("k", "kernel", 0, 10 * US), ("k", "kernel", 20 * US, 10 * US),
                                 ("k", "kernel", 40 * US, 10 * US),
                                 ("k", "kernel", 100 * US, 10 * US)],
                     launches=[(12 * US, 6 * US)],
                     host_ops=[("scan.run", 30 * US, 40 * US)],
                     entry_bytes={}, tick_bytes=0, peak_bytes_per_s=1.0)
    # gaps at 15 (a launch), 35 (inside scan.run), 75 (no host event)
    assert tool._unnamed_gaps(tr, [("scan.run", 30 * US, 40 * US)]) == {
        "all": 1, "in_scan_run": 0}
    assert tool._unnamed_gaps(tr, [("scan.run", 0, 200 * US)]) == {"all": 1, "in_scan_run": 1}
