"""Z-HAF: Zone Holographic Availability Field (§III-E, §IV-B).

A port of ``repro.core.zhaf``: the per-node reported (stale) state view with
staggered, jittered node reports subject to packet loss and smoothed
first-order derivatives. The reading side, the Taylor projection ``S_pred =
max(0, S + tau_i * S_dot)`` and the short-project / long-degrade
missing-data rule applied to a DA's candidates, is part of the addressing
step, ``repro_torch.kernels.utility_topk`` (``utility_topk_address``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitmap
from repro_torch.core.config import LaminarConfig
from repro_torch.core.draws import Draws
from repro_torch.core.state import QUEUED, SimState, scatter_sum


class NodeView(NamedTuple):
    """True node state, computed once per tick and shared by all subsystems."""

    bits: torch.Tensor | None  # (N, A) free-atom bit plane; None in mesh mode
    s_true: torch.Tensor  # (N,) free atoms
    h_true: torch.Tensor  # (N,) pending DA count (Heat)
    run_true: torch.Tensor  # (N,) longest contiguous free run


def node_heat(cfg: LaminarConfig, s: SimState) -> torch.Tensor:
    """Heat = count of pending DAs in each node's arbitration queue."""
    queued = s.st == QUEUED
    return scatter_sum(cfg.num_nodes, s.node, queued, queued.to(torch.int32))


def build_view(cfg: LaminarConfig, s: SimState) -> NodeView:
    bits = bitmap.unpack_bits(s.free, cfg.atoms_per_node)
    s_true = torch.sum(bits, dim=-1).to(torch.float32)
    run_true = bitmap.max_run(bits).to(torch.float32)
    h_true = node_heat(cfg, s).to(torch.float32)
    return NodeView(bits, s_true, h_true, run_true)


def report(cfg: LaminarConfig, s: SimState, d: Draws, view: NodeView) -> SimState:
    """Fire due node reports (base interval + Gaussian jitter, 1% loss)."""
    due = s.t >= s.next_rep
    delivered = due & s.node_up & (d.rep_loss >= cfg.hop_loss)

    s_true, h_true, run_true = view.s_true, view.h_true, view.run_true

    dt_ms = torch.clamp((s.t - s.rep_t).to(torch.float32) * cfg.dt_ms, min=cfg.dt_ms)
    a = cfg.deriv_ema
    dS_new = (1 - a) * s.dS + a * (s_true - s.rep_S) / dt_ms
    dH_new = (1 - a) * s.dH + a * (h_true - s.rep_H) / dt_ms

    interval = cfg.ticks(cfg.report_interval_ms + cfg.extra_sync_delay_ms)
    jitter = cfg.report_jitter_frac * interval * d.rep_jit
    next_rep = torch.where(
        due,
        s.t + torch.clamp(interval + jitter.to(torch.int32), min=1),
        s.next_rep,
    )

    return s._replace(
        rep_S=torch.where(delivered, s_true, s.rep_S),
        rep_H=torch.where(delivered, h_true, s.rep_H),
        rep_run=torch.where(delivered, run_true, s.rep_run),
        rep_t=torch.where(delivered, s.t, s.rep_t),
        dS=torch.where(delivered, dS_new, s.dS),
        dH=torch.where(delivered, dH_new, s.dH),
        next_rep=next_rep,
    )
