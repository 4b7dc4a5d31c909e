"""Spans and counters: where the port's time goes, recorded only when asked.

``span(name)`` marks a stretch of the program; spans nest. What one does
depends only on what is open in its thread, never on a flag:

* a ``torch.profiler`` profile: the span is also a range of the
  profiler's own (``_RecordFunctionFast``), a host event on the clock of the
  trace's device operations. It is an operator's range, not a user
  annotation, so the profiler draws no copy of it among the device's
  operations, where it would count as device time;
* a :func:`recording`: the span keeps ``Span(name, parent, start_ns,
  end_ns)`` (``parent``: the index of the enclosing span in the same
  recording, -1 for none), its times from ``time.time_ns()``, the clock
  ``torch.profiler`` gives its host events, so a recorded span lines up
  with a profiled trace; ``count(name, n)`` adds ``n`` to the recording's
  counter ``name``;
* a stage map (:class:`StageMap`, open only while ``core.scan`` captures a
  tick): the span notes the capture's position at its entry and its exit,
  so each node of the captured graph can be given the path of the
  innermost span that enqueued it;
* none of these: a span checks three things and does nothing else: no
  dispatcher call, no profiler range, nothing kept.

The tick's spans run on the host only when the tick does: eagerly, or once
at its capture; a replayed graph runs none of them.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

_profiling = torch._C._autograd._profiler_enabled
# a profiler range that dispatches no operator and is no user annotation
# (torch._inductor marks its launches with it); None: spans are not profiled
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the recording, -1 for none
    start_ns: int  # time.time_ns(), the clock of torch.profiler's host events
    end_ns: Optional[int]  # None while the span is open


class Recording:
    """What the spans and counters of one :func:`recording` block kept, in
    the order the spans were entered."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}

    def total_ns(self, name: str) -> int:
        """Summed duration of the closed spans ``name``."""
        return sum(sp.end_ns - sp.start_ns for sp in self.spans
                   if sp.name == name and sp.end_ns is not None)


class StageMap:
    """The capture's position at each span's entry and exit while a tick is
    captured. ``position()`` gives the node the next captured operation will
    depend on (0 before the first); it raises ``RuntimeError`` where the
    position cannot be read, and the map then keeps the first such reason in
    ``fault`` and reads no further."""

    def __init__(self, position: Callable[[], int]):
        self.position = position
        self.marks: List[list] = []  # [path, position at entry, position at exit]
        self.fault: Optional[str] = None
        self.prefix = ""  # the path of the span open where the map opened (set by mapping())

    def _read(self) -> Optional[int]:
        if self.fault is not None:
            return None
        try:
            return self.position()
        except RuntimeError as e:
            self.fault = str(e)
            return None

    def enter(self, path: str) -> int:
        """Note a span's entry; its path counts from the map's opening."""
        if self.prefix:
            path = path[len(self.prefix) + 1:]
        self.marks.append([path, self._read(), None])
        return len(self.marks) - 1

    def exit(self, mark: int) -> None:
        self.marks[mark][2] = self._read()

    def resolve(self, chain: List[Tuple[int, str]]) -> Tuple[Optional[list], Optional[str]]:
        """``(stages, None)``: ``(kind, path)`` for each kernel, memcpy and
        memset node of ``chain`` (the captured graph's nodes in order, each
        ``(handle, kind)``), the path of the innermost span that enqueued
        it ("" for none); or ``(None, reason)``."""
        if self.fault is not None:
            return None, self.fault
        index = {h: i for i, (h, _) in enumerate(chain)}
        spans = []
        for path, lo, hi in self.marks:
            if lo is None or hi is None:
                return None, f"span {path} has no position"
            if (lo and lo not in index) or (hi and hi not in index):
                return None, f"span {path}'s position is no node of the graph"
            spans.append((path, index[lo] if lo else -1, index[hi] if hi else -1))
        out = []
        for i, (_, kind) in enumerate(chain):
            if kind in ("kernel", "memcpy", "memset"):
                # the last span entered that holds node i is the innermost
                path = next((p for p, lo, hi in reversed(spans) if lo < i <= hi), "")
                out.append((kind, path))
        return out, None


class _Open(threading.local):
    """What is open in this thread."""

    def __init__(self):
        self.recordings: List[Recording] = []
        self.maps: List[StageMap] = []
        self.stack: list = []  # the frames of the spans entered while a recording or map was open


_open = _Open()


class span:
    """A named stretch of the program (see the module's docstring)."""

    __slots__ = ("name", "_frame")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _open
        prof = _Range is not None and _profiling()
        if not (prof or st.recordings or st.maps):
            self._frame = None
            return self
        rf = None
        if prof:
            rf = _Range(self.name)
            rf.__enter__()
        if not (st.recordings or st.maps):
            self._frame = (rf, None, (), ())
            return self
        parent = st.stack[-1] if st.stack else None
        path = self.name if parent is None else f"{parent[1]}/{self.name}"
        marks = tuple((m, m.enter(path)) for m in st.maps)
        start = time.time_ns()
        held = tuple((rec, _enter(rec, self.name, parent, start)) for rec in st.recordings)
        self._frame = (rf, path, marks, held)
        st.stack.append(self._frame)
        return self

    def __exit__(self, *exc) -> None:
        frame = self._frame
        if frame is None:
            return
        rf, path, marks, held = frame
        if path is not None:
            for m, mark in marks:
                m.exit(mark)
            end = time.time_ns()
            for rec, i in held:
                rec.spans[i] = rec.spans[i]._replace(end_ns=end)
            _open.stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)


def _enter(rec: Recording, name: str, parent, start: int) -> int:
    """Open span ``name`` in ``rec`` under the frame ``parent``: its index."""
    up = -1
    if parent is not None:
        up = next((i for r, i in parent[3] if r is rec), -1)
    rec.spans.append(Span(name, up, start, None))
    return len(rec.spans) - 1


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of every open recording."""
    for rec in _open.recordings:
        rec.counters[name] = rec.counters.get(name, 0) + n


def recording_open() -> bool:
    """Whether a recording is open in this thread (a counter would be kept)."""
    return bool(_open.recordings)


@contextmanager
def recording():
    """Keep, in the :class:`Recording` it yields, every span entered and
    every count made inside the block (in this thread)."""
    rec = Recording()
    _open.recordings.append(rec)
    try:
        yield rec
    finally:
        _open.recordings.remove(rec)


@contextmanager
def mapping(stage_map: StageMap):
    """Note, in ``stage_map``, the capture's position at the entry and exit
    of every span inside the block; their paths start inside the block."""
    stage_map.prefix = _open.stack[-1][1] if _open.stack else ""
    _open.maps.append(stage_map)
    try:
        yield stage_map
    finally:
        _open.maps.remove(stage_map)
