"""Slurm-like: the coordination-bound bottleneck (§V-A), a port of
``repro.core.baselines.slurm_like``.

A globally serialized scheduler with a single authoritative resource view and
a strict global FIFO. Per-decision cost is wildly optimistic (0.01 us/node
scan + 0.1 us match + 0.5 us mutex), but the architecture's unavoidable
physical constraint is enforced: every placement holds the global mutex, and
beyond 10k queued decisions a non-linear lock-convoy penalty activates.
Losers retry up to 3 times at 2 ms backoff. No task timeout (deliberate
concession: a passive queue generates no signaling while waiting).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.baselines import common as C
from repro_torch.core import floatops as fo
from repro_torch.core.baselines.draws import BaselineDraws
from repro_torch.core.config import BaselineConfig, LaminarConfig
from repro_torch.core.engine import _resolve_device


class SlurmState(NamedTuple):
    tt: C.TaskTable
    free: torch.Tensor
    carry: torch.Tensor  # fractional decision budget
    t: torch.Tensor
    scen: C.ScenarioState
    metrics: C.BaseMetrics


MAX_PROC = 64  # max decisions evaluated per tick (budget-masked)


def decision_rate(cfg: LaminarConfig, bcfg: BaselineConfig, q: torch.Tensor) -> torch.Tensor:
    """Decisions per tick with ``q`` tasks queued: ``dt / t_dec(q)``, where
    the mutex cost grows by the lock convoy ``max(1, (q / depth) ** power)``.

    Rounded as the reference's program rounds it: ``q / depth`` is a
    multiply by the float32 reciprocal, a square becomes ``q * q`` times the
    folded constant ``r * r``, and the mutex term's multiply-add is fused.
    (Another ``slurm_convoy_power`` takes ``torch.pow``, whose rounding is
    not held to the reference's.)
    """
    r = fo.recip(bcfg.slurm_convoy_depth)
    if bcfg.slurm_convoy_power == 2.0:
        convoy = q * q * fo.f32(fo.f32(r) * fo.f32(r))
    else:
        convoy = torch.pow(q * r, bcfg.slurm_convoy_power)
    convoy = torch.clamp(convoy, min=1.0)
    base = cfg.num_nodes * bcfg.slurm_scan_us_per_node + bcfg.slurm_match_us
    t_dec_us = fo.fma(convoy, fo.f32(bcfg.slurm_mutex_us), fo.f32(base))
    return fo.div(cfg.dt_ms * 1e3, t_dec_us)


def make_step(cfg: LaminarConfig, bcfg: BaselineConfig):
    """Build ``step(state, draws) -> (state', (arrived, started, completed))``.
    The arrival intensity enters through the draws' Poisson count."""

    def step(s: SlurmState, d: BaselineDraws) -> Tuple[SlurmState, torch.Tensor]:
        tt, free, m, scen = s.tt, s.free, s.metrics, s.scen

        tt, free, m = C.complete(cfg, tt, free, m)
        scen, tt, free, m = C.scenario_tick(cfg, scen, tt, free, m, s.t, d)
        tt, m, _ = C.inject(cfg, tt, m, d, s.t)

        # backoff progress
        in_backoff = tt.st == C.B_BACKOFF
        timer = torch.where(in_backoff, tt.timer - 1, tt.timer)
        tt = tt._replace(
            st=torch.where(in_backoff & (timer <= 0), C.B_QUEUED, tt.st), timer=timer
        )

        # --- global head-of-line budget under the mutex ---------------------
        queued = tt.st == C.B_QUEUED
        carry = s.carry + decision_rate(cfg, bcfg, C.count(queued).to(torch.float32))
        n_proc = torch.clamp(torch.floor(carry), max=MAX_PROC).to(torch.int32)
        carry = carry - n_proc.to(torch.float32)

        # oldest n_proc queued tasks get a decision this tick
        sel = C.select_oldest(queued, tt.arrival, MAX_PROC, n_proc)

        # centralized view is exact & fresh: spread the batch over the
        # currently slackest nodes (one per node; batch members conflict-free)
        top_nodes = C.top_k(C.slack(cfg, free), MAX_PROC)
        rank = torch.cumsum(sel, 0, dtype=torch.int32) - 1  # rank among selected
        node = top_nodes[torch.clamp(rank, 0, MAX_PROC - 1).long()]
        tt = tt._replace(node=torch.where(sel, node, tt.node))

        tt, free, m, admit, reject = C.admit_fifo(cfg, tt, free, sel, s.t, m)

        # losers retry (bounded) at 2 ms backoff, else fail
        can_retry = reject & (tt.retries < bcfg.slurm_retries)
        give_up = reject & ~can_retry
        tt = tt._replace(
            st=torch.where(can_retry, C.B_BACKOFF, torch.where(give_up, C.B_EMPTY, tt.st)),
            timer=torch.where(can_retry, cfg.ticks(bcfg.slurm_backoff_ms), tt.timer),
            retries=torch.where(can_retry, tt.retries + 1, tt.retries),
        )
        m = m._replace(
            failed=m.failed + C.count(give_up),
            retries=m.retries + C.count(can_retry),
        )
        # NO task timeout for Slurm-like (unbounded in-memory queuing concession)
        s = SlurmState(tt, free, carry, s.t + 1, scen, m)
        return s, torch.stack([m.arrived, m.started, m.completed])

    return step


def init(cfg: LaminarConfig, seed: int = 0, capacity: int = 1 << 17, device="cuda"):
    """The initial state on ``device`` and the per-tick arrival intensity."""
    dev = _resolve_device(device)
    free, lam = C.init_cluster(cfg, seed, dev)
    s = SlurmState(
        tt=C.TaskTable.empty(capacity, free.shape[1], dev),
        free=free,
        carry=torch.zeros((), dtype=torch.float32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        scen=C.scenario_init(cfg, free),
        metrics=C.BaseMetrics.zeros(dev),
    )
    return s, lam


def run(cfg: LaminarConfig, bcfg: BaselineConfig | None = None, seed: int = 0,
        capacity: int = 1 << 17, num_ticks: int | None = None, device="cuda", draws=None):
    """One run and its summary. ``device`` defaults to ``"cuda"`` and
    raises without it unless ``device="cpu"``; ``draws`` overrides the
    generator-backed provider on the device."""
    return C.run_model("slurm", init, make_step, cfg, bcfg, seed, capacity, num_ticks,
                       device, draws)
