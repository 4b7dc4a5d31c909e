"""Airlock: bounded node-local runtime survival (§III-G/H/I, Exp5).

A port of ``repro.core.airlock``. Severe physical memory pressure becomes an
ordered policy instead of blind kernel OOM destruction:

  pressure > high watermark  ->  suspension in ascending E_v order
  pressure < safe watermark  ->  in-situ resume (before T_susp)
  suspension beyond T_susp   ->  resident DA secondary reactivation
  T_surv expiry              ->  bounded reclamation of task + DA

With Airlock disabled, above the kill watermark the largest-memory resident
is destroyed outright. The per-tick *decision* is the ``survival_scan``
hot-path op; this module applies it to the state table and the metrics.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.arbiter import _free_atoms_at
from repro_torch.core.config import LaminarConfig, MemoryConfig
from repro_torch.core.draws import Draws
from repro_torch.core.floatops import f32
from repro_torch.core.state import EMPTY, RUNNING, SUSPENDED, SimState, count, tier_counts


def noise_scale(mc: MemoryConfig) -> float:
    """The ambient noise's scale ``sqrt(1 - decay^2) * sigma`` as the JAX
    package computes it, in float32: each step in double is exact or rounds
    once to the float32 result (a float32 square root and product)."""
    return f32(f32(math.sqrt(f32(1 - mc.ambient_decay**2))) * f32(mc.noise_sigma))


def memory_dynamics(cfg: LaminarConfig, s: SimState, d: Draws,
                    scale: float | None = None) -> SimState:
    """Exp5 dynamic perturbation: AR(1) ambient noise + Bernoulli bursts +
    slow per-node drift (neighboring rigid workloads breathing). ``scale``
    is :func:`noise_scale` of ``cfg.memory``, which the tick computes once,
    outside the tick; given None it is computed here."""
    mc = cfg.memory
    if not mc.enabled:
        return s
    N = cfg.num_nodes
    decay = mc.ambient_decay
    noise = (noise_scale(mc) if scale is None else scale) * d.mem_noise
    burst = (d.burst_u < mc.burst_rate).to(torch.float32) * d.burst_v * mc.burst_scale
    phase = torch.arange(N, dtype=torch.float32, device=s.amb.device) * 2.399
    tsec = s.t.to(torch.float32) * cfg.dt_ms / 1e3
    drift = mc.drift_kappa * 0.5 * (1.0 + torch.sin(2 * math.pi * tsec + phase))
    amb = torch.clamp(decay * (s.amb - drift) + noise + burst + drift, 0.0, 0.8)
    return s._replace(amb=amb)


def runtime_control(
    cfg: LaminarConfig, s: SimState, victim: torch.Tensor
) -> SimState:
    """Apply the per-node survival action (one action/node/tick)."""
    if not cfg.memory.enabled:
        return s

    if not cfg.airlock:
        # kernel OOM: destroy outright (badness ~ memory footprint)
        free = _free_atoms_at(s.free, s.alloc, s.alloc_node, victim)
        m = s.metrics
        m = m._replace(
            oom_kill_f=m.oom_kill_f + count(victim & ~s.contig),
            oom_kill_l=m.oom_kill_l + count(victim & s.contig),
            oom_kill_tier=m.oom_kill_tier + tier_counts(s.tier, victim),
        )
        return s._replace(
            st=torch.where(victim, EMPTY, s.st),
            free=free,
            alloc=torch.where(victim[:, None], 0, s.alloc),
            alloc_node=torch.where(victim, -1, s.alloc_node),
            mem=torch.where(victim, 0.0, s.mem),
            metrics=m,
        )

    # Airlock: reverse-recursive suspension, ascending E_v (lowest value first)
    m = s.metrics
    m = m._replace(suspended_cnt=m.suspended_cnt + count(victim))
    return s._replace(
        st=torch.where(victim, SUSPENDED, s.st),
        susp_tick=torch.where(victim, s.t, s.susp_tick),
        migrating=torch.where(victim, False, s.migrating),
        metrics=m,
    )


def airlock_transitions(
    cfg: LaminarConfig,
    s: SimState,
    resume: torch.Tensor,
    react: torch.Tensor,
    expire: torch.Tensor,
) -> Tuple[SimState, torch.Tensor]:
    """Apply in-situ resume / threshold-triggered reactivation / survival
    expiry masks (from ``hotpath.survival_scan``).

    Returns (state, reactivation_dispatch_mask): reactivated DAs re-enter the
    network through TEG exactly like fresh probes.
    """
    if not (cfg.memory.enabled and cfg.airlock):
        return s, torch.zeros_like(s.migrating)

    st = torch.where(resume, RUNNING, s.st)
    migrating = torch.where(react, True, s.migrating)
    patience = torch.where(react, s.ev, s.patience)  # fresh E_patience budget
    surv_deadline = torch.where(
        react, s.t + cfg.ticks(cfg.t_surv_ms), s.surv_deadline
    )

    free = _free_atoms_at(s.free, s.alloc, s.alloc_node, expire)
    free = _free_atoms_at(free, s.alloc2, s.node2, expire & (s.node2 >= 0))
    st = torch.where(expire, EMPTY, st)

    m = s.metrics
    m = m._replace(
        resumed_insitu=m.resumed_insitu + count(resume),
        reactivated=m.reactivated + count(react),
        reclaimed=m.reclaimed + count(expire),
        reclaimed_tier=m.reclaimed_tier + tier_counts(s.tier, expire),
    )
    s = s._replace(
        st=st,
        migrating=torch.where(expire, False, migrating),
        patience=patience,
        surv_deadline=surv_deadline,
        free=free,
        alloc=torch.where(expire[:, None], 0, s.alloc),
        alloc_node=torch.where(expire, -1, s.alloc_node),
        alloc2=torch.where(expire[:, None], 0, s.alloc2),
        node2=torch.where(expire, -1, s.node2),
        metrics=m,
    )
    return s, react & ~expire
