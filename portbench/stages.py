"""One cell's tick stage by stage on the card: the spans and the stage map
that the port records (``repro_torch.core.spans``), read by
``benchlib.stages``.

    python3 portbench/stages.py --workload CELL --seed N [--pairs K] [--out FILE]

From the root of a checkout, on a machine with an NVIDIA card. The cell's
program (``benchlib.program``) is set up and warmed up under a recording,
then runs ``K`` pairs of segments, one unrecorded and one recorded, each
timed on the host from a wait for the device, then one segment under
``torch.profiler``. The last line of standard output is one JSON object:

* ``setup``: seconds to the end of the warm-up, the first segment's
  (the capture's) seconds, and the recorded ``engine.init`` and
  ``scan.capture`` spans' seconds (``setup.init_s``, ``setup.capture_s``);
* ``enqueue``: host ms a replay of the unrecorded and the recorded
  segments (medians), the recorded ``scan.*`` spans' ms a replay and the
  ``scan.launch_ns`` counter's (``scan.launch_ms``);
* ``census``: the captured graph's nodes by kind (``kernel_bench.
  graph_census``) and the seconds a walk of its chain takes (what the
  stage map adds to a capture after the capture ends);
* ``profiled``: the profiled segment's wall seconds; the device ms a
  replay of every operation, of the graph's, and of each top-level stage
  (``stage.<name>_ms``, the device ms a replay of the nodes under one
  top-level span, ``benchlib.stages``) and of its ``indexFuncLargeIndex``
  kernels (the ``index_add_`` pair), or why none could be attributed; the
  idle gaps that no host event names, all and inside ``scan.run``. With
  ``--out``, the file also holds the stage table and the stage map.

Standard error gets the stage table: each innermost span path, its device
ms a replay and its nodes, and the rows outside the graph. On a tree whose
port has no spans, the set-up, the unrecorded enqueue, the census and the
profiled wall time are still measured, for a comparison in one call.
"""

import argparse
import bisect
import json
import statistics
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import run as bench_run

SCAN = ("scan.run", "scan.lookup", "scan.load", "scan.replays", "scan.unload")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    bench_run._environment()

    import torch

    from benchlib import spec

    try:
        cell = spec.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        return bench_run.fail(f"cannot load workload {args.workload!r}: {e}")
    if not torch.cuda.is_available():
        return bench_run.fail("CUDA is not available: the stages are the card's")
    out = measure(cell, args.seed, args.pairs)
    if "why" in out["profiled"]:
        print(f"portbench: no stage attributed: {out['profiled']['why']}", file=sys.stderr)
    for path, ms, nodes in out["profiled"].get("table", []):
        print(f"stage {ms:10.6f} ms {nodes:5d} {path}", file=sys.stderr)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out) + "\n")
    out["profiled"].pop("table", None)
    out["profiled"].pop("map", None)
    print(json.dumps(out), flush=True)
    return 0


def measure(cell, seed: int, pairs: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchlib import program as prog_mod
    from benchlib import stages as stages_mod
    from benchlib import trace as trace_mod
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census
    from repro_torch.kernels import _build

    try:
        from repro_torch.core import spans
    except ImportError:  # a port without spans
        spans = None

    def recording():
        return spans.recording() if spans is not None else nullcontext()

    dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    with recording() as rec:
        _build.build()
        prog = prog_mod.Program(cell, seed, dev)
        sync()
        t1 = time.perf_counter()
        prog.segment()
        sync()
        first_s = time.perf_counter() - t1
        for _ in range(int(cell.traffic["warmup_ticks"]) // prog.seg - 1):
            prog.segment()
        sync()
    setup = {"seconds": time.perf_counter() - t0, "first_segment_s": first_s}
    if rec is not None:
        setup["setup.init_s"] = rec.total_ns("engine.init") / 1e9
        setup["setup.capture_s"] = rec.total_ns("scan.capture") / 1e9

    per_replay = 1e3 / prog.seg  # seconds a segment -> ms a replay
    off, on, split = [], [], {n: [] for n in SCAN + ("scan.launch_ns",)}
    for _ in range(pairs):
        sync()
        t1 = time.perf_counter()
        prog.segment()
        off.append((time.perf_counter() - t1) * per_replay)
        sync()
        if spans is None:
            continue
        with spans.recording() as r:
            t1 = time.perf_counter()
            prog.segment()
            on.append((time.perf_counter() - t1) * per_replay)
        sync()
        for n in SCAN:
            split[n].append(r.total_ns(n) / 1e9 * per_replay)
        split["scan.launch_ns"].append(r.counters.get("scan.launch_ns", 0) / 1e9 * per_replay)
    enqueue = {"unrecorded_ms": statistics.median(off)}
    if on:
        enqueue["recorded_ms"] = statistics.median(on)
        enqueue.update({f"{n}_ms": statistics.median(v) for n, v in split.items()
                        if n != "scan.launch_ns"})
        enqueue["scan.launch_ms"] = statistics.median(split["scan.launch_ns"])

    sync()
    with watching() as runs, profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        prog.segment()
        sync()
        wall = time.perf_counter() - t1
    ((compiled, _),) = runs
    replays = prog.seg
    census = {k: v for k, v in graph_census(compiled.graph).items() if k != "names"}
    if spans is not None and compiled.graph is not None:
        from repro_torch.core.scan import graph_chain

        t1 = time.perf_counter()
        graph_chain(compiled.graph)
        census["chain_walk_s"] = time.perf_counter() - t1

    tr = trace_mod.from_profiler(prof, replays=replays, seeds=len(prog.seeds), wall_s=wall,
                                 enqueue_s=0.0, entry_bytes={}, tick_bytes=0,
                                 peak_bytes_per_s=1.0)
    ev = stages_mod.from_profiler(prof, SCAN)
    profiled = {"wall_s": wall, "replays": replays,
                "device_ms": tr.device_s() / replays * 1e3,
                "unnamed_gaps": _unnamed_gaps(tr, ev.spans)}
    att, why = stages_mod.attribute(getattr(compiled, "stages", None), ev)
    if att is None:
        profiled["why"] = why if spans is not None else "the port has no spans"
    else:
        profiled["graph_ms"] = att.graph_ns() / replays / 1e6
        profiled["outside_ms"] = {k: v / replays / 1e6 for k, v in att.outside.items()}
        profiled["stages"] = {f"stage.{t.split('.', 1)[1]}_ms": att.stage_ms(t)
                              for t in stages_mod.TOP}
        profiled["index_add_ms"] = att.named_ms("indexFuncLargeIndex")
        profiled["table"] = att.table()
        profiled["map"] = compiled.stages
    return {"cell": cell.name, "seed": seed, "device": torch.cuda.get_device_name(dev),
            "setup": setup, "enqueue": enqueue, "census": census, "profiled": profiled}


def _unnamed_gaps(tr, spans) -> dict:
    """The device's idle gaps that the trace's breakdown would label "none"
    (no host event open at the gap's middle): all of them, and those inside
    a ``scan.run`` span."""
    runs = [(s, s + d) for n, s, d in spans if n == "scan.run"]
    host = sorted((s, s + d) for _, s, d in tr.host_ops + [("", s, d) for s, d in tr.launches])
    covered = []  # the union of the host events' intervals
    for s, e in host:
        if covered and s <= covered[-1][1]:
            covered[-1][1] = max(covered[-1][1], e)
        else:
            covered.append([s, e])
    starts = [s for s, _ in covered]
    busy = tr.busy_intervals()
    out = {"all": 0, "in_scan_run": 0}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) // 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid <= covered[k][1]:
            continue
        out["all"] += 1
        out["in_scan_run"] += any(a <= mid <= b for a, b in runs)
    return out


if __name__ == "__main__":
    sys.exit(main())
