"""The tick's stages on the device: a profiled segment's graph operations
attributed to the stage map of its captured tick.

The port maps a captured tick as it captures it (``repro_torch.core.scan``
``Compiled.stages``): each kernel, memcpy and memset node of the graph in
chain order, with the path of the innermost span that enqueued it
(``repro_torch.core.spans``; e.g. ``tick.admission/da.address/
hotpath.utility_topk_address``). Here:

* a replay's device operations are those the profiler correlates with
  that replay's ``cudaGraphLaunch``, in start order, and the n-th of them
  is the map's n-th node. Where any replay's operations differ from the
  map in number, or a kernel node's operation is a copy or a fill, nothing
  is attributed (None, and why): no operation is guessed to a stage. (A
  memcpy or memset node may run as a kernel: CUDA runs a graph's
  device-to-device copies as ``memcpy32_post`` kernels.);
* the operations of no graph launch (PyTorch's replay prologue, which
  fills each registered generator's seed and offset before a replay, and
  the run's copies in and out) are rows of their own, each named by the
  program span around the host call that launched it (``scan.replays``:
  the replay prologue).

A stage metric is the device ms a replay of the nodes under one top-level
span (:meth:`Attribution.stage_ms`).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

# the top-level spans of a captured tick's body, in the order it runs them
TOP = ("scan.draws", "tick.survival", "tick.completions", "tick.disruption",
       "tick.dissemination", "tick.admission", "tick.arbitration", "tick.pending",
       "scan.copyback")
PROLOGUE = "scan.replays"  # the span whose launches outside the graph are the replay prologue


@dataclasses.dataclass
class Events:
    """What a profile holds for the attribution."""

    device_ops: List[Tuple[str, str, int, int, int]]  # (name, kind, start ns, dur ns, correlation)
    graph_launches: List[Tuple[int, int, int]]  # cudaGraphLaunch: (start ns, dur ns, correlation)
    calls: Dict[int, int]  # correlation -> start ns of the host call that launched it
    spans: List[Tuple[str, int, int]]  # the program's spans: (name, start ns, dur ns)


@dataclasses.dataclass
class Attribution:
    replays: int
    by_path: Dict[str, List[int]]  # innermost path -> [device ns over all replays, nodes a replay]
    outside: Dict[str, int]  # the span around the launching call -> device ns (no graph's)
    by_name: Dict[Tuple[str, str], int]  # (top-level span, operation's name) -> device ns

    def graph_ns(self) -> int:
        return sum(ns for ns, _ in self.by_path.values())

    def stage_ms(self, top: str) -> Optional[float]:
        """Device ms a replay of the nodes under the top-level span ``top``
        (None where the map has no node there)."""
        hit = [ns for p, (ns, _) in self.by_path.items() if p.split("/", 1)[0] == top]
        return sum(hit) / self.replays / 1e6 if hit else None

    def named_ms(self, part: str) -> Dict[str, float]:
        """Device ms a replay, by top-level span, of the graph's operations
        whose name holds ``part``."""
        out: Dict[str, float] = defaultdict(float)
        for (top, name), ns in self.by_name.items():
            if part in name:
                out[top] += ns / self.replays / 1e6
        return dict(out)

    def table(self) -> List[Tuple[str, float, int]]:
        """``(path, device ms a replay, nodes a replay)`` for each innermost
        path in the map's order, then each row outside the graph (nodes
        -1), the replay prologue's named ``replay prologue``."""
        rows = [(p or "(no span)", ns / self.replays / 1e6, n)
                for p, (ns, n) in self.by_path.items()]
        for label, ns in self.outside.items():
            name = "replay prologue" if label == PROLOGUE else f"outside the graph: {label}"
            rows.append((name, ns / self.replays / 1e6, -1))
        return rows


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def from_profiler(prof, span_names: Sequence[str] = ()) -> Events:
    """The device operations with their correlation ids, the graph launches,
    the host calls that launched anything, and the host events named in
    ``span_names``, of a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = set(span_names)
    ev = Events([], [], {}, [])
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if e.is_user_annotation():  # a host range drawn on the device: no work
                continue
            ev.device_ops.append((name, _kind(name), start, dur, e.correlation_id()))
        elif name in names:
            ev.spans.append((name, start, dur))
        elif name.startswith("cuda"):  # a runtime call
            ev.calls[e.correlation_id()] = start
            if name.startswith("cudaGraphLaunch"):
                ev.graph_launches.append((start, dur, e.correlation_id()))
    ev.graph_launches.sort()
    return ev


def _innermost(spans, at: int) -> str:
    inner = [(d, n) for n, s, d in spans if s <= at <= s + d]
    return min(inner)[1] if inner else "none"


def attribute(stages: Optional[Sequence[Tuple[str, str]]],
              ev: Events) -> Tuple[Optional[Attribution], Optional[str]]:
    """``(attribution, None)``, or ``(None, why)`` where nothing can be
    attributed: no map, no graph launch, or a replay whose operations
    differ from the map in number, or whose kernel node ran as a copy."""
    if stages is None:
        return None, "the compiled tick has no stage map"
    if not ev.graph_launches:
        return None, "no cudaGraphLaunch in the trace"
    per: Dict[int, list] = {c: [] for _, _, c in ev.graph_launches}
    outside: Dict[str, int] = defaultdict(int)
    for op in ev.device_ops:
        if op[4] in per:
            per[op[4]].append(op)
        else:
            at = ev.calls.get(op[4])
            outside["none" if at is None else _innermost(ev.spans, at)] += op[3]
    by_path: Dict[str, List[int]] = {}
    by_name: Dict[Tuple[str, str], int] = defaultdict(int)
    for path in dict.fromkeys(p for _, p in stages):
        by_path[path] = [0, 0]
    for _, path in stages:
        by_path[path][1] += 1
    for k, (_, _, corr) in enumerate(ev.graph_launches):
        ops = sorted(per[corr], key=lambda o: o[2])
        if len(ops) != len(stages):
            return None, (f"replay {k}: {len(ops)} device operations against the map's "
                          f"{len(stages)} nodes")
        for n, (op, (kind, path)) in enumerate(zip(ops, stages)):
            if op[1] != kind and not (op[1] == "kernel" and kind != "kernel"):
                return None, f"replay {k}: operation {n} is a {op[1]}, the map's node a {kind}"
            by_path[path][0] += op[3]
            by_name[path.split("/", 1)[0], op[0]] += op[3]
    return Attribution(len(ev.graph_launches), by_path, dict(outside), dict(by_name)), None
