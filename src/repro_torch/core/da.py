"""DA: the Decentralized Agent lifecycle (§III-F, §IV-C), a port of
``repro.core.da``.

Phase I (kinetic addressing) lives here: connectionless hops with loss,
bounded candidate evaluation against the projected Z-HAF field, single-hop
bounce to j*, patience accounting, Fast-Fail, and TEG-side regeneration of
lost probes (bounded instances, quiet interval).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import hotpath, zhaf
from repro_torch.core.config import LaminarConfig
from repro_torch.core.draws import Draws
from repro_torch.core.state import (
    ADDRESSING,
    BOUNCING,
    EMPTY,
    LOST_WAIT,
    QUEUED,
    ROUTING,
    SUSPENDED,
    SimState,
    count,
)
from repro_torch.core.utility import unified_utility


def _dissipate_st(s: SimState, mask: torch.Tensor) -> torch.Tensor:
    """Kill the control incarnation. A migrating DA reverts to the suspended
    glass-state; an ordinary probe's slot is freed."""
    st = torch.where(mask & s.migrating, SUSPENDED, s.st)
    st = torch.where(mask & ~s.migrating, EMPTY, st)
    return st


def move(cfg: LaminarConfig, s: SimState, d: Draws) -> Tuple[SimState, torch.Tensor]:
    """Advance in-flight probes one tick; returns (state, regen_dispatch_mask).

    Packet loss applies to DA *bounce* hops; the TEG first hop is not subject
    to the probe loss process.
    """
    in_flight = (s.st == ROUTING) | (s.st == BOUNCING)
    timer = torch.where(in_flight | (s.st == LOST_WAIT), s.timer - 1, s.timer)
    arrived = in_flight & (timer <= 0)

    lost = arrived & (s.st == BOUNCING) & (d.move_loss < cfg.hop_loss)
    ok = arrived & ~lost

    st = s.st
    st = torch.where(ok & (s.st == ROUTING), ADDRESSING, st)
    st = torch.where(ok & (s.st == BOUNCING), QUEUED, st)

    m = s.metrics
    if cfg.regeneration:
        st = torch.where(lost, LOST_WAIT, st)
        timer = torch.where(lost, cfg.ticks(cfg.regen_quiet_ms), timer)
    else:
        st = torch.where(lost, _dissipate_st(s, lost), st)
        m = m._replace(lost=m.lost + count(lost))

    # regeneration: quiet interval elapsed -> respawn via TEG (fresh patience,
    # bounded instance count), else exhausted -> dissipate.
    quiet_done = (s.st == LOST_WAIT) & (timer <= 0)
    can_regen = quiet_done & (s.regen < cfg.regen_cap)
    exhausted = quiet_done & ~can_regen
    st = torch.where(exhausted, _dissipate_st(s, exhausted), st)

    regen = torch.where(can_regen, s.regen + 1, s.regen)
    patience = torch.where(can_regen, s.ev, s.patience)

    if cfg.regeneration:
        m = m._replace(
            lost=m.lost + count(lost),
            regen_spawned=m.regen_spawned + count(can_regen),
            regen_exhausted=m.regen_exhausted + count(exhausted),
        )

    s = s._replace(st=st, timer=timer, regen=regen, patience=patience, metrics=m)
    return s, can_regen


def address(
    cfg: LaminarConfig, s: SimState, d: Draws, view: zhaf.NodeView
) -> SimState:
    """One bounded addressing round for every kinetic DA (st == ADDRESSING).

    Candidate 0 is the current launchpad; k-1 more are sampled uniformly inside
    the Zone. If j* is the launchpad we enqueue locally; otherwise one bounce.
    """
    active = s.st == ADDRESSING

    zc = torch.clamp(s.zcount[s.zone], min=1).to(torch.float32)
    cand = s.zstart[s.zone][:, None] + torch.floor(d.cand_u * zc[:, None]).to(torch.int32)
    cand = torch.clamp(cand, 0, cfg.num_nodes - 1)
    here = torch.clamp(s.node, min=0)
    cand = torch.cat([here[:, None], cand], dim=1)

    s_eff, h_eff, run_eff = zhaf.project(cfg, s, cand)
    # Candidate 0 is the node the DA stands on: it is evaluated against TRUE
    # local state (the projections are fresh tensors, written in place)
    s_eff[:, 0] = view.s_true[here]
    h_eff[:, 0] = view.h_true[here]
    run_eff[:, 0] = view.run_true[here]
    mass_f = s.mass.to(torch.float32)[:, None]
    feas = torch.where(s.contig[:, None], run_eff >= mass_f, s_eff >= mass_f)

    # fused utility scoring + candidate argmax: the utility_topk hot-path op
    eps = cfg.addr_noise_sigma * d.addr_eps
    best, best_score = hotpath.utility_topk(
        s_eff, h_eff, eps, feas, cfg.gamma_repulsion
    )

    any_feas = torch.any(feas, dim=1)
    target = torch.gather(cand, 1, best[:, None].long())[:, 0]

    # Controlled sub-optimality: a feasible launchpad is "sufficiently good"
    # unless a remote candidate beats it by more than stay_margin bits. On
    # CUDA best_score comes from the kernel and here_score from torch's own
    # elementwise ops: the kernel repeats them exactly (see utility.py).
    here_ok = feas[:, 0]
    here_score = torch.where(
        here_ok,
        unified_utility(s_eff[:, 0], h_eff[:, 0], cfg.gamma_repulsion) + eps[:, 0],
        -torch.inf,
    )
    prefer_here = here_ok & (best_score <= here_score + cfg.stay_margin)
    target = torch.where(prefer_here, here, target)

    stay = active & any_feas & (target == s.node)
    bounce = active & any_feas & (target != s.node)

    patience = torch.where(active, s.patience - cfg.eval_cost, s.patience)
    patience = torch.where(bounce, patience - cfg.bounce_cost, patience)

    st = torch.where(stay, QUEUED, s.st)
    st = torch.where(bounce, BOUNCING, st)
    node = torch.where(bounce, target, s.node)
    timer = torch.where(bounce, 1, s.timer)  # single hop
    zone = torch.where(bounce, s.zone_id[target], s.zone)

    # Fast-Fail: patience below the floor dissipates the probe locally.
    ff = active & (patience < cfg.fastfail_floor)
    st = torch.where(ff, _dissipate_st(s._replace(st=st), ff), st)

    m = s.metrics
    m = m._replace(
        op_eval=m.op_eval + count(active),
        op_bounce=m.op_bounce + count(bounce & ~ff),
        fastfail=m.fastfail + count(ff),
    )
    return s._replace(
        st=st, node=node, zone=zone, timer=timer, patience=patience, metrics=m
    )
