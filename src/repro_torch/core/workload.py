"""Bimodal open-loop Poisson workload generation (§V-A).

A port of ``repro.core.workload``. The tick draws ``max_arrivals_per_tick``
candidate tasks and masks the first ``n`` of them by the Poisson count, which
keeps every shape fixed. The random values themselves come from ``Draws``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.config import LaminarConfig
from repro_torch.core.draws import Draws


class ArrivalBatch(NamedTuple):
    n: torch.Tensor  # number of real arrivals this tick (<= n_max)
    contig: torch.Tensor  # L-task flag
    squat: torch.Tensor
    tier: torch.Tensor  # workload class: 0 prod / 1 batch / 2 best-effort
    mass: torch.Tensor
    ev: torch.Tensor  # E_v,init = p_i * m_i * tier_mult  (energy contract)
    patience: torch.Tensor  # E_patience(0) = E_i(0)
    service: torch.Tensor  # service duration in ticks
    pull: torch.Tensor  # payload pull duration in ticks


def sample_arrivals(cfg: LaminarConfig, d: Draws) -> ArrivalBatch:
    w = cfg.workload
    n = torch.clamp(d.arr_n, max=cfg.max_arrivals_per_tick).to(torch.int32)

    is_l = d.arr_l >= w.f_share
    squat = d.arr_squat < w.squatter_ratio
    tier = d.arr_tier

    mass = torch.where(is_l, d.arr_mass_l, d.arr_mass_f).to(torch.int32)
    prio = torch.where(is_l, d.arr_pri_l, d.arr_pri_f)

    # E_i(0) = p_i * m_i, scaled by the workload-class multiplier; the
    # search-patience budget stays at the unscaled base energy
    base_energy = prio * mass.to(torch.float32)
    # a select chain rather than a table lookup: no host-to-device copy
    tier_mult = torch.full_like(base_energy, w.tier_ev_mult[-1])
    for code in range(len(w.tier_ev_mult) - 2, -1, -1):
        tier_mult = torch.where(tier == code, w.tier_ev_mult[code], tier_mult)
    ev = base_energy * tier_mult

    # F: exponential service; L: lognormal (heavier tail).
    svc_f = d.arr_svc_exp * w.f_service_mean_ms
    svc_l = w.l_service_median_ms * torch.exp(w.l_service_sigma * d.arr_svc_norm)
    svc_ms = torch.where(is_l, svc_l, svc_f)
    service = torch.clamp(torch.round(svc_ms / cfg.dt_ms), min=1).to(torch.int32)

    pull_mean = torch.where(is_l, cfg.l_pull_mean_ms, cfg.f_pull_mean_ms)
    pull_ms = d.arr_pull_exp * pull_mean
    pull = torch.clamp(torch.round(pull_ms / cfg.dt_ms), min=1).to(torch.int32)

    return ArrivalBatch(
        n=n,
        contig=is_l,
        squat=squat,
        tier=tier,
        mass=mass,
        ev=ev,
        patience=base_energy,
        service=service,
        pull=pull,
    )


def lambda_per_tick(cfg: LaminarConfig, free_atoms_total: float) -> float:
    """Open-loop arrival intensity per tick for the configured rho."""
    lam_s = cfg.arrival_rate_per_s(free_atoms_total)
    return lam_s * cfg.dt_ms / 1e3
