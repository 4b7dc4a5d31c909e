"""The port's spans and counters (``repro_torch.core.spans``), on the CPU.

  * spans nest, each recorded with its parent; with nothing open a span
    keeps nothing and dispatches nothing;
  * under ``torch.profiler`` a span is a host event, and a recorded span
    lies on the profiler's clock;
  * one eager tick holds each of its top-level stages once, in the paper's
    order: flat, lockstep under ``torch.func.vmap``, storm, memory off;
  * the tick's aten ops (``analysis.trace_audit``'s fingerprints) are the
    same with spans doing nothing, recording, or not there at all;
  * the compiled run's spans and its launch counter; the stage map of a
    capture, from made-up positions here and from a real capture on a card
    (marked ``cuda``).
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import trace_audit
from repro_torch.core import LaminarConfig, LaminarEngine, MemoryConfig, spans
from repro_torch.core.draws import BatchDraws
from repro_torch.core.engine import make_step
from repro_torch.core.scan import Compiled, scan
from repro_torch.core.spans import StageMap, span
from repro_torch.workloads import SCENARIOS

SMALL = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=256, max_arrivals_per_tick=32,
                      horizon_ms=10.0, rho=0.8, airlock=True, memory=MemoryConfig(enabled=True))
STAGES = ("tick.survival", "tick.completions", "tick.disruption", "tick.dissemination",
          "tick.admission", "tick.arbitration", "tick.pending")
TOP = STAGES + ("scan.draws", "scan.copyback")


def _paths(rec):
    """Each recorded span's path, in entry order."""
    out = []
    for sp in rec.spans:
        out.append(sp.name if sp.parent < 0 else f"{out[sp.parent]}/{sp.name}")
    return out


def test_spans_nest_with_their_parents():
    with spans.recording() as rec:
        with span("a"):
            with span("b"):
                with span("c"):
                    pass
            with span("d"):
                spans.count("n", 2)
        with span("e"):
            spans.count("n", 3)
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("a", -1), ("b", 0), ("c", 1), ("d", 0), ("e", -1)]
    assert all(s.start_ns <= s.end_ns for s in rec.spans)
    a, b, c, d, e = rec.spans
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= e.start_ns
    assert rec.counters == {"n": 5}
    assert rec.total_ns("b") == b.end_ns - b.start_ns


def test_a_recording_opened_inside_a_span_starts_its_own_tree():
    with spans.recording() as outer:
        with span("a"):
            with spans.recording() as inner:
                with span("b"):
                    pass
    assert [(s.name, s.parent) for s in outer.spans] == [("a", -1), ("b", 0)]
    assert [(s.name, s.parent) for s in inner.spans] == [("b", -1)]


def test_with_nothing_open_a_span_keeps_and_dispatches_nothing():
    with trace_audit.OpRecorder() as ops:
        with span("a"):
            with span("b"):
                spans.count("n", 1)
    assert ops.ops == []
    assert spans._open.stack == []
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_under_the_profiler_a_span_is_a_host_event_on_the_recordings_clock():
    with span("nothing open"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof, spans.recording() as rec:
        with span("warm"):
            pass
        with span("outer"):
            with span("inner"):
                torch.ones(4).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert "nothing open" not in events
    # an operator's range, not a user annotation: a profile on a card draws
    # no copy of it among the device's operations
    assert not any(events[n].is_user_annotation() for n in ("warm", "outer", "inner"))
    for sp in rec.spans[1:]:
        e = events[sp.name]
        # the recorded span lies inside the profiler's own event for it
        # (4-10 us later and earlier on an idle host): one clock
        assert e.start_ns() <= sp.start_ns <= sp.end_ns <= e.end_ns()
        assert sp.start_ns - e.start_ns() < 1_000_000
    assert rec.spans[2].parent == 1


def _tick_case(case):
    cfg = SMALL
    if case == "storm":
        cfg = dataclasses.replace(cfg, scenario=SCENARIOS["storm"])
    elif case == "memory-off":
        cfg = dataclasses.replace(cfg, airlock=False, memory=MemoryConfig(enabled=False))
    elif case == "kernel-oom":
        cfg = dataclasses.replace(cfg, airlock=False)
    return cfg


@pytest.mark.parametrize("case", ["flat", "lockstep", "storm", "memory-off", "kernel-oom"])
def test_one_tick_holds_each_stage_once_in_order(case):
    cfg = _tick_case(case)
    eng = LaminarEngine(cfg, device="cpu")
    step = make_step(cfg)
    if case == "lockstep":
        s, lam = eng.init_batch([0, 1])
        d = BatchDraws([eng.draws(lam, s.zstart.shape[1], sd) for sd in (0, 1)]).tick(0)
        tick = torch.func.vmap(step, in_dims=(0, BatchDraws.in_dims(d)))
    else:
        s, lam = eng.init(0)
        d = eng.draws(lam, s.zstart.shape[0], 0).tick(0)
        tick = step
    with spans.recording() as rec:
        tick(s, d)
    top = [sp.name for sp in rec.spans if sp.parent < 0]
    want = [n for n in STAGES if n != "tick.disruption" or case == "storm"]
    assert top == want
    paths = _paths(rec)
    hot = {p.rsplit("/", 1)[-1] for p in paths if "hotpath." in p}
    assert hot == ({"hotpath.zone_aggregate_members", "hotpath.utility_topk_address",
                    "hotpath.bitmap_fit_rounds", "hotpath.node_view"}
                   | ({"hotpath.survival_scan"} if case != "memory-off" else set()))
    assert "tick.admission/da.address/hotpath.utility_topk_address" in paths
    assert "tick.dissemination/zhaf.build_view/hotpath.node_view" in paths
    # every scatter-add of the tick runs under one span, named in the stage table;
    # with Airlock off the kill branch's two lie under runtime control
    scatter = {p.rsplit("/", 1)[0] for p in paths if p.endswith("/state.scatter_sum")}
    survival = {"memory-off": set(), "kernel-oom": {"tick.survival/airlock.runtime_control"}}
    assert scatter == ({"tick.completions/arbiter.completions", "tick.dissemination/zhaf.build_view",
                        "tick.pending/arbiter.pending_stage", "tick.pending/arbiter.timeouts"}
                       | survival.get(case, {"tick.survival/airlock.airlock_transitions"})
                       | ({"tick.disruption/disrupt.apply"} if case == "storm" else set()))
    if case == "kernel-oom":
        assert paths.count("tick.survival/airlock.runtime_control/state.scatter_sum") == 2


def _fingerprints():
    out = []
    for cfg in (SMALL, _tick_case("storm"), _tick_case("memory-off")):
        out.append(trace_audit.fingerprint(trace_audit.record_tick(cfg)[0]))
    return out


class _Inert:
    """A span that does nothing at all: the tick as if it had no spans."""

    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def test_spans_leave_the_ticks_ops_as_they_are(monkeypatch):
    plain = _fingerprints()
    with spans.recording() as rec:
        recorded = _fingerprints()
    assert rec.spans, "the recording saw the ticks"
    monkeypatch.setattr(spans.span, "__enter__", _Inert.__enter__)
    monkeypatch.setattr(spans.span, "__exit__", _Inert.__exit__)
    monkeypatch.setattr(spans.span, "__init__", _Inert.__init__)
    without = _fingerprints()
    assert plain == recorded == without


def test_a_compiled_run_spans_its_call_and_its_parts():
    eng = LaminarEngine(SMALL, device="cpu")
    s, lam = eng.init(0)
    with spans.recording() as rec:
        eng.simulate(s, eng.draws(lam, s.zstart.shape[0], 0), 3)
    paths = _paths(rec)
    assert [p for p in paths if p.count("/") == 0] == ["scan.run"]
    assert [p for p in paths if p.count("/") == 1] == [
        "scan.run/scan.lookup", "scan.run/scan.load", "scan.run/scan.replays",
        "scan.run/scan.unload"]
    # on the CPU each tick is the body itself, under scan.replays
    body = [p.rsplit("/", 1)[-1] for p in paths if p.count("/") == 2]
    assert body == ["scan.draws", "tick.survival", "tick.completions", "tick.dissemination",
                    "tick.admission", "tick.arbitration", "tick.pending", "scan.copyback"] * 3
    assert rec.counters == {}  # no graph, no launch


class _Replayed:
    """A stand-in graph: ``replay()`` runs the body, as the CPU does."""

    def __init__(self, body):
        self.replay = body


def test_the_launch_counter_sums_the_host_time_inside_replays():
    eng = LaminarEngine(SMALL, device="cpu")
    s, lam = eng.init(0)
    cache = {}
    draws = eng.draws(lam, s.zstart.shape[0], 0)
    scan(make_step(SMALL), s, draws, 1, cache=cache, key=("k",))
    (compiled,) = cache.values()
    compiled.graph = _Replayed(compiled._body)
    ref_state, ref_ts = scan(make_step(SMALL), s, eng.draws(lam, s.zstart.shape[0], 1), 4,
                             cache={}, key=("k",))
    with spans.recording() as rec:
        st, ts = scan(None, s, eng.draws(lam, s.zstart.shape[0], 1), 4, cache=cache,
                      key=("k",))
    assert torch.equal(ts, ref_ts)
    assert set(rec.counters) == {"scan.launch_ns"}
    replays = next(sp for sp in rec.spans if sp.name == "scan.replays")
    assert 0 < rec.counters["scan.launch_ns"] <= replays.end_ns - replays.start_ns


def test_a_cpu_compiled_tick_has_no_stage_map():
    eng = LaminarEngine(SMALL, device="cpu")
    s, lam = eng.init(0)
    cache = {}
    scan(make_step(SMALL), s, eng.draws(lam, s.zstart.shape[0], 0), 1, cache=cache)
    (compiled,) = cache.values()
    assert isinstance(compiled, Compiled)
    assert compiled.stages is None and "CPU" in compiled.stages_fault


class _Capture:
    """Made-up capture positions: each "operation" appends a node to a
    chain, and the position is the last node (0 before the first)."""

    def __init__(self):
        self.chain = []

    def op(self, kind="kernel"):
        self.chain.append((1000 + len(self.chain), kind))

    def position(self):
        return self.chain[-1][0] if self.chain else 0


def test_a_stage_map_gives_each_node_its_innermost_span():
    cap = _Capture()
    m = StageMap(cap.position)
    with spans.mapping(m):
        with span("scan.draws"):
            cap.op()
        with span("tick.a"):
            cap.op()
            with span("x.f"):
                with span("hotpath.g"):
                    cap.op()
                    cap.op("other")  # not listed, but counts in the chain
                cap.op("memset")
            with span("x.empty"):
                pass
            cap.op("memcpy")
        cap.op()  # outside every span
    stages, fault = m.resolve(cap.chain)
    assert fault is None
    assert stages == [("kernel", "scan.draws"), ("kernel", "tick.a"),
                      ("kernel", "tick.a/x.f/hotpath.g"), ("memset", "tick.a/x.f"),
                      ("memcpy", "tick.a"), ("kernel", "")]


def test_a_stage_maps_paths_start_where_it_opened():
    cap = _Capture()
    m = StageMap(cap.position)
    with spans.recording(), span("scan.run"), span("scan.capture"):
        with spans.mapping(m), span("tick.a"), span("x.f"):
            cap.op()
    assert m.resolve(cap.chain) == ([("kernel", "tick.a/x.f")], None)


def test_a_stage_map_reads_none_with_a_reason_and_never_raises():
    def broken():
        raise RuntimeError("the next captured operation depends on 2 nodes")

    m = StageMap(broken)
    with spans.mapping(m):
        with span("tick.a"):
            pass
    assert m.resolve([(1, "kernel")]) == (None, "the next captured operation depends on 2 nodes")
    cap = _Capture()
    m = StageMap(cap.position)
    with spans.mapping(m):
        cap.op()
        with span("tick.a"):
            cap.op()
    stages, fault = m.resolve(cap.chain[1:])  # a position that is no node of the chain
    assert stages is None and "no node" in fault


@pytest.mark.cuda
@pytest.mark.parametrize("lockstep", [False, True], ids=["flat", "lockstep"])
def test_captured_tick_stage_map_covers_every_node(lockstep):
    """On a card: the captured small Exp5 tick's graph is a chain, and its
    stage map lists every kernel, memcpy and memset node that
    ``graph_census`` counts, each inside one of the body's top-level
    spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA (an NVIDIA GPU)")
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census

    cfg = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024,
                        max_arrivals_per_tick=64, horizon_ms=40.0, rho=0.8, airlock=True,
                        memory=MemoryConfig(enabled=True))
    eng = LaminarEngine(cfg, device="cuda")
    with watching() as runs, spans.recording():  # map paths start inside the capture
        if lockstep:
            sb, lam = eng.init_batch([0, 1])
            eng.simulate_batch(sb, BatchDraws([eng.draws(lam, sb.zstart.shape[1], sd)
                                               for sd in (0, 1)]), 5)
        else:
            s, lam = eng.init(0)
            eng.simulate(s, eng.draws(lam, s.zstart.shape[0], 0), 5)
    torch.cuda.synchronize()
    ((compiled, _),) = runs
    assert compiled.stages_fault is None, compiled.stages_fault
    census = graph_census(compiled.graph)
    kinds = [k for k, _ in compiled.stages]
    for kind in ("kernel", "memcpy", "memset"):
        assert kinds.count(kind) == census[kind]
    tops = {p.split("/", 1)[0] for _, p in compiled.stages}
    assert tops <= set(TOP) and {"scan.draws", "scan.copyback", "tick.admission"} <= tops
    # the address entry is one kernel node; under vmap its inputs' copies join it
    hits = sum(p.endswith("hotpath.utility_topk_address") for _, p in compiled.stages)
    assert hits >= 1 if lockstep else hits == 1
