"""The system under test: the port's compiled engine, driven segment by segment.

Everything of the program this benchmark touches is here: the port's
``LaminarEngine`` (``init``/``init_batch``, ``draws``, ``simulate`` or
``simulate_batch``), its config classes, ``summarize`` and
``core.scan.watching``. A segment is one call of ``simulate`` (a flat
cell) or ``simulate_batch`` (a lockstep cell) of the traffic's
``segment_ticks`` ticks; each continues from the state the last returned,
with the same draw providers.

``core.scan`` restarts its tick counter at 0 on every call, and the draws
read it for the arrival-rate schedule. For a stationary schedule that
counter is not read; a periodic one (diurnal, flash) reads it modulo its
period, so a segment is a whole number of periods. For ``mmpp`` each tick
reads the burst state of its dwell segment from the provider's burst
table, so before each call the table is set to the window of the run's
burst states that starts at the call's first dwell segment
(:meth:`Program.place`), and a segment is a whole number of dwell
segments. A chain of calls then draws what one call of all their ticks
draws (``tests/test_portbench_reference.py``).
"""

from __future__ import annotations

import random
import time
from typing import Any, List, Optional

import torch

from benchlib import spec


class Program:
    """One cell's engine on ``device``: the state of ``seeds`` (lockstep) or
    of one seed, their draw providers, and the segments run so far."""

    def __init__(self, cell: spec.Cell, seed: int, device):
        from repro_torch.core import config as pconfig
        from repro_torch.core.draws import BatchDraws
        from repro_torch.core.engine import LaminarEngine

        tr = cell.traffic
        self.cell = cell
        self.device = torch.device(device)
        self.cfg = spec.build_config(pconfig, cell.config["config"], tr["scenario"])
        self.seeds = [seed + i for i in range(int(tr["seeds"]))]
        self.lockstep = bool(tr["lockstep"])
        if not self.lockstep and len(self.seeds) != 1:
            raise ValueError(f"traffic {cell.traffic_name}: a flat cell runs one seed")
        self.seg = int(tr["segment_ticks"])
        self.engine = LaminarEngine(self.cfg, device=self.device)
        if self.lockstep:
            self.init_state, self.lam = self.engine.init_batch(self.seeds)
            zones = self.init_state.zstart.shape[1]
        else:
            self.init_state, self.lam = self.engine.init(self.seeds[0])
            zones = self.init_state.zstart.shape[0]
        self.providers = [self.engine.draws(self.lam, zones, sd) for sd in self.seeds]
        self.draws = BatchDraws(self.providers) if self.lockstep else self.providers[0]
        self._sim = self.engine.simulate_batch if self.lockstep else self.engine.simulate
        self.state = self.init_state
        self.tick = 0  # ticks run since the initial state
        self._bursts = self._burst_tables()

    # ------------------------------------------------------------------
    def _burst_tables(self) -> Optional[List[torch.Tensor]]:
        """The run's mmpp burst states of each seed on the device (the
        benchmark's own, from the seed: ``reference.schedule``), or None.
        A periodic schedule reads the tick counter modulo its period, so its
        segments must be whole periods."""
        from reference import schedule as ref_schedule

        sched = self.cfg.scenario.schedule
        if sched.kind in ("diurnal", "flash"):
            period = ref_schedule.schedule_period_ticks(sched, self.cfg.dt_ms)
            if self.seg % period:
                raise ValueError(f"segment_ticks {self.seg} is not a whole number of "
                                 f"{sched.kind} periods of {period} ticks")
        if sched.kind != "mmpp":
            return None
        dwell = ref_schedule._ticks(sched.mmpp_dwell_ms, self.cfg.dt_ms)
        if self.seg % dwell:
            raise ValueError(f"segment_ticks {self.seg} is not a whole number of "
                             f"mmpp dwell segments of {dwell} ticks")
        self.dwell = dwell
        return [torch.from_numpy(ref_schedule.burst_states(sched, sd, 1 << 17)).to(self.device)
                for sd in self.seeds]

    def place(self) -> None:
        """Set each provider's burst table to the run's burst states from the
        next call's first dwell segment on."""
        if self._bursts is None:
            return
        first = self.tick // self.dwell
        for p, full in zip(self.providers, self._bursts):
            n = p.tables.bursts.shape[0]
            if first + n > full.shape[0]:
                raise RuntimeError("the run outlasts its burst states")
            p.tables = p.tables._replace(bursts=full[first:first + n])

    def segment(self):
        """Run one segment from the current state: returns (start state,
        end state, series, first tick). Nothing waits for the device."""
        self.place()
        start, t0 = self.state, self.tick
        self.state, ts = self._sim(self.state, self.draws, self.seg)
        self.tick += self.seg
        return start, self.state, ts, t0

    # ------------------------------------------------------------------
    def seed_state(self, s, i: int):
        """Seed ``i``'s state out of a (batched) state."""
        from repro_torch.core.engine import seed_state

        return seed_state(s, i) if self.lockstep else s

    def seed_series(self, ts: torch.Tensor, i: int) -> torch.Tensor:
        return ts[i] if self.lockstep else ts

    def summarize(self, s, ts) -> dict:
        from repro_torch.core.engine import summarize

        return summarize(self.cfg, s, ts.cpu().numpy())


class Sample:
    """One segment of the window, drawn uniformly from the seed's stream by
    reservoir sampling (the window's length is not known beforehand)."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed * 2654435761 % (1 << 61) + 0x5E61)
        self.seen = 0
        self.kept: Any = None

    def offer(self, seg) -> None:
        self.seen += 1
        if self.rng.randrange(self.seen) == 0:
            self.kept = seg


def warm_up(prog: Program, ticks: int, sync):
    """The cell's warm-up: ``ticks`` ticks in segments (the first captures
    the tick), then a wait for the device (``sync``). Returns the first
    segment, which the start check follows."""
    if ticks < prog.seg or ticks % prog.seg:
        raise ValueError(f"warmup_ticks {ticks} is not a positive multiple of "
                         f"segment_ticks {prog.seg}")
    first = prog.segment()
    for _ in range(ticks // prog.seg - 1):
        prog.segment()
    sync()
    return first


def window(prog: Program, seconds: float, sample: Sample, sync) -> dict:
    """Segments until ``seconds`` of wall time have passed, closed at the
    first segment boundary after that, at a wait for the device (``sync``).
    The host runs at most one segment ahead of the device: before it
    checks the clock it waits for the previous segment's end (an event),
    so the window ends within a segment of ``seconds``. Every segment is
    offered to ``sample``."""
    pending = []
    t0 = time.perf_counter()
    segments = 0
    while True:
        seg = prog.segment()
        segments += 1
        sample.offer(seg)
        if prog.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 1:
                pending.pop(0).synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "segments": segments,
            "seed_ticks": segments * prog.seg * len(prog.seeds), "last": seg}
