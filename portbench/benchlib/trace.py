"""The traced stretch, reduced from ``torch.profiler``'s events for the
per-layer metrics' readers (``metrics/<name>.py``).

The stretch is one segment of the cell run after the window under the
profiler: ``replays`` graph replays (a lockstep replay runs every seed's
tick). A reader takes a :class:`Trace` and returns its number, or None
where the trace holds nothing it reads.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Trace:
    replays: int  # graph replays in the stretch (a lockstep one is every seed's tick)
    seeds: int
    wall_s: float  # host clock over the stretch, to the device's end
    enqueue_s: float  # host clock over the enqueue of the segment before, untraced
    device_ops: List[Tuple[str, str, int, int]]  # (name, kind, start ns, duration ns)
    launches: List[Tuple[int, int]]  # cudaGraphLaunch runtime calls: (start ns, duration ns)
    host_ops: List[Tuple[str, int, int]]  # other host events: (name, start ns, duration ns)
    entry_bytes: Dict[str, int]  # hot-path entry -> least bytes a launch (benchlib.roofline)
    tick_bytes: int  # the least bytes a replay moves
    peak_bytes_per_s: float

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, sorted, as (start,
        end) in ns."""
        spans = sorted((s, s + d) for _, _, s, d in self.device_ops)
        out: List[Tuple[int, int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> Optional[float]:
        """Seconds in which some operation ran on the device (None: the
        profiler recorded no device operation)."""
        if not self.device_ops:
            return None
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_s(self, kinds=("kernel", "memcpy", "memset"), names=None, exclude=None) -> float:
        """Summed device seconds of the operations of ``kinds`` whose name
        holds one of ``names`` (all if None) and none of ``exclude``."""
        tot = 0
        for name, kind, _, d in self.device_ops:
            if kind not in kinds:
                continue
            if names is not None and not any(n in name for n in names):
                continue
            if exclude is not None and any(n in name for n in exclude):
                continue
            tot += d
        return tot / 1e9

    def count(self, kinds=("kernel",), names=None) -> int:
        return sum(1 for name, kind, _, _ in self.device_ops if kind in kinds
                   and (names is None or any(n in name for n in names)))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations of the most summed time, and the longest
        idle gaps of the device, each named by the host event that was
        running at the gap's middle (the innermost, or "none")."""
        by_name: Dict[str, int] = defaultdict(int)
        for name, _, _, d in self.device_ops:
            by_name[name] += d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = sorted(((busy[k + 1][0] - busy[k][1], busy[k][1]) for k in range(len(busy) - 1)),
                      reverse=True)[:top]
        host = sorted(self.host_ops + [("cudaGraphLaunch", s, d) for s, d in self.launches],
                      key=lambda e: e[1])
        named = []
        for length, at in gaps:
            mid = at + length // 2
            inner = [e for e in host if e[1] <= mid <= e[1] + e[2]]
            label = min(inner, key=lambda e: e[2])[0] if inner else "none"
            named.append([label, length / 1e9])
        return {"device_ops": [[n, d / 1e9] for n, d in ops], "idle_gaps": named}


def _kind(name: str) -> str:
    """A device operation's kind by the name CUPTI gives it."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _raw_events(prof):
    """(name, on the device, start ns, duration ns) of every event the
    profiler kept: its raw Kineto events where this PyTorch has them,
    else its ``events()``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    try:
        for e in prof.profiler.kineto_results.events():
            yield e.name(), e.device_type() == cuda, e.start_ns(), e.duration_ns()
    except AttributeError:
        for e in prof.events():
            yield (e.name, e.device_type == cuda, int(e.time_range.start * 1000),
                   int(e.time_range.elapsed_us() * 1000))


def from_profiler(prof, replays: int, seeds: int, wall_s: float, enqueue_s: float,
                  entry_bytes: dict, tick_bytes: int, peak_bytes_per_s: float) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``."""
    device_ops, launches, host_ops = [], [], []
    for name, on_device, start, dur in _raw_events(prof):
        if on_device:
            device_ops.append((name, _kind(name), start, dur))
        elif name.startswith("cudaGraphLaunch"):
            launches.append((start, dur))
        else:
            host_ops.append((name, start, dur))
    return Trace(replays=replays, seeds=seeds, wall_s=wall_s, enqueue_s=enqueue_s,
                 device_ops=device_ops,
                 launches=sorted(launches), host_ops=host_ops, entry_bytes=entry_bytes,
                 tick_bytes=tick_bytes, peak_bytes_per_s=peak_bytes_per_s)
