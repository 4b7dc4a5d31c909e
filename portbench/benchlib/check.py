"""Whether what the program's timed path produced is correct.

The plain reference (``reference``) works each checked stretch out again,
eagerly, one seed at a time, and every number compared has the limit 0:
the engine is exact, and the port holds its kernels to their plain
versions bit for bit, so a sound run differs from the reference in no
element. The reference runs from what the benchmark makes itself (the
configuration, the seed, the burst states) except where it follows the
window: there it starts from the program's state at the start of a
segment drawn from the seed, since following every tick of a window from
the start would take longer than the window. So the start and the first
segment are checked by themselves, from the reference's own initial state.

The numbers compared, each a count of elements that differ:

* ``init``: the program's initial state (every seed's row) against the
  reference's ``init``;
* ``start``: one seed's state after the first segment of the warm-up,
  against the reference from its own initial state;
* ``segment``: every seed's state at the end of the sampled segment of
  the window, against the reference from the program's state at its
  start; ``series`` the segment's per-tick counters likewise;
* ``summary``: the fields of ``summarize`` of the program's final state
  that differ from the reference's ``summarize`` of it.

A lower precision (``follow(..., round_to=torch.bfloat16)``) is the
control: every float32 field of the state rounded to bfloat16 after each
tick.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchlib import spec
from reference import config as rconfig
from reference import draws as rdraws
from reference import tick as rtick

LIMIT = 0  # every number compared is a count of elements that differ


def ref_config(cell: spec.Cell):
    return spec.build_config(rconfig, cell.config["config"], cell.traffic["scenario"])


def _leaves(s):
    """(name, tensor) of every field of a state, the metrics' too."""
    for f in s._fields:
        x = getattr(s, f)
        if f == "metrics":
            for g in x._fields:
                yield f"metrics.{g}", getattr(x, g)
        else:
            yield f, x


def state_mismatches(got, want) -> Dict[str, int]:
    """Elements of each field that differ (NaN equals NaN); fields that
    match are left out. A field whose shape or dtype differs counts whole."""
    out = {}
    w = dict(_leaves(want))
    for name, a in _leaves(got):
        b = w[name].to(a.device)
        if a.shape != b.shape or a.dtype != b.dtype:
            out[name] = max(a.numel(), b.numel())
            continue
        same = a == b
        if a.is_floating_point():
            same |= torch.isnan(a) & torch.isnan(b)
        n = int((~same).sum())
        if n:
            out[name] = n
    return out


def tensor_mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    b = b.to(a.device)
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


def summary_mismatches(got: dict, want: dict) -> list:
    """The keys of two ``summarize`` dicts whose values differ."""
    bad = []
    for k in sorted(set(got) | set(want)):
        a, b = got.get(k), want.get(k)
        if isinstance(a, dict) and isinstance(b, dict):
            bad += [f"{k}.{j}" for j in summary_mismatches(a, b)]
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            if not np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True):
                bad.append(k)
        elif isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
            continue
        elif a != b or type(a) is not type(b):
            bad.append(k)
    return bad


class Reference:
    """The reference of one cell on ``device``: its config, its initial
    state from ``seeds[0]`` and each seed's draws."""

    def __init__(self, cell: spec.Cell, seeds, device):
        self.cfg = ref_config(cell)
        self.seeds = list(seeds)
        self.device = torch.device(device)
        self.init_state, self.lam = rtick.init(self.cfg, self.seeds[0], self.device)
        self.zones = self.init_state.zstart.shape[0]
        self.step = rtick.make_step(self.cfg)
        self._per_tick: Optional[int] = None

    def draws(self, i: int, first_tick: int):
        """Seed ``i``'s draws from tick ``first_tick`` on. On a CUDA device
        its generator moves to that tick's offset (every tick draws the same
        amount of its Philox stream); a CPU generator has no offset, so it
        draws the ticks before (small runs only: the tests')."""
        d = rdraws.TorchDraws(self.cfg, self.lam, self.zones, seed=self.seeds[i],
                              device=self.device)
        if self.device.type != "cuda":
            for k in range(first_tick):
                d.tick(k)
            return d
        if self._per_tick is None:
            probe = rdraws.TorchDraws(self.cfg, self.lam, self.zones, seed=self.seeds[i],
                                      device=self.device)
            o0 = probe.gen.get_offset()
            probe.tick(0)
            self._per_tick = probe.gen.get_offset() - o0
        d.gen.set_offset(d.gen.get_offset() + first_tick * self._per_tick)
        return d

    def follow(self, s, i: int, first_tick: int, ticks: int, round_to=None):
        """``ticks`` ticks of seed ``i`` from state ``s`` at tick
        ``first_tick``: the final state and the (ticks, 11) series. With
        ``round_to`` a lower precision, every float32 field of the state is
        rounded through it after each tick (the control)."""
        d = self.draws(i, first_tick)
        rows = []
        for k in range(ticks):
            s, row = self.step(s, d.tick(first_tick + k))
            if round_to is not None:
                s = _rounded(s, round_to)
            rows.append(row)
        return s, torch.stack(rows)

    def summarize(self, s, ts: torch.Tensor) -> dict:
        return rtick.summarize(self.cfg, s, ts.cpu().numpy())


def _rounded(s, dtype):
    def r(x):
        return x.to(dtype).to(torch.float32) if x.dtype == torch.float32 else x

    return type(s)(*(type(x)(*(r(y) for y in x)) if f == "metrics" else r(x)
                     for f, x in zip(s._fields, s)))


def as_ref_state(s):
    """A state of the program (any NamedTuple of its fields) as the
    reference's ``SimState``, tensors shared."""
    from reference.state import Metrics, SimState

    fields = {f: getattr(s, f) for f in SimState._fields if f != "metrics"}
    m = Metrics(**{f: getattr(s.metrics, f) for f in Metrics._fields})
    return SimState(**fields, metrics=m)


def check_run(prog, ref: Reference, first, sampled, last, seed: int) -> dict:
    """Compare a run's outputs with the reference.

    ``first``, ``sampled`` and ``last`` are segments ``(start, end, series,
    first tick)`` of the program (or of whatever stands in its place): the
    warm-up's first, the window's sampled one and the window's last.
    Returns the numbers compared, each ``{"value", "limit"}``; ``failed``,
    the checked seed-segments that differ (the start's seed, each seed of
    the sampled segment, each seed's summary); the mismatched fields of
    each number; and the seconds the reference took."""
    t0 = time.perf_counter()
    B = len(ref.seeds)
    rng = np.random.default_rng([seed, 0xC4EC])
    detail: Dict[str, object] = {}

    init_bad: Dict[str, int] = {}
    for i in range(B):
        for k, v in state_mismatches(as_ref_state(prog.seed_state(prog.init_state, i)),
                                     ref.init_state).items():
            init_bad[k] = init_bad.get(k, 0) + v
    detail["init"] = init_bad

    i0 = int(rng.integers(B))
    start, end, _, t_first = first
    s_ref, _ = ref.follow(ref.init_state, i0, t_first, prog.seg)
    start_bad = state_mismatches(as_ref_state(prog.seed_state(end, i0)), s_ref)
    detail["start"] = {"seed": ref.seeds[i0], **start_bad}

    start, end, ts, t_seg = sampled
    failed = int(bool(start_bad))
    seg_bad: Dict[str, int] = {}
    series_bad = 0
    for i in range(B):
        s_ref, ts_ref = ref.follow(as_ref_state(prog.seed_state(start, i)), i, t_seg, prog.seg)
        bad = state_mismatches(as_ref_state(prog.seed_state(end, i)), s_ref)
        for k, v in bad.items():
            seg_bad[k] = seg_bad.get(k, 0) + v
        n_series = tensor_mismatches(prog.seed_series(ts, i), ts_ref)
        series_bad += n_series
        failed += int(bool(bad) or n_series > 0)
    detail["segment"] = {"first_tick": t_seg, **seg_bad}

    _, fin, ts_last, _ = last
    summary_bad = []
    for i in range(B):
        fin_i, ts_i = prog.seed_state(fin, i), prog.seed_series(ts_last, i)
        bad = summary_mismatches(prog.summarize(fin_i, ts_i),
                                 ref.summarize(as_ref_state(fin_i), ts_i))
        summary_bad += bad
        failed += int(bool(bad))
    detail["summary"] = summary_bad

    numbers = {
        "init": sum(init_bad.values()),
        "start": sum(start_bad.values()),
        "segment": sum(seg_bad.values()),
        "series": series_bad,
        "summary": len(summary_bad),
    }
    return {
        "numbers": {k: {"value": v, "limit": LIMIT} for k, v in numbers.items()},
        "failed": failed,
        "detail": detail,
        "seconds": time.perf_counter() - t0,
    }
