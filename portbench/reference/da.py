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

from . import hotpath, zhaf
from .config import LaminarConfig
from .draws import Draws
from .state import (
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
    the Zone and evaluated against the projected Z-HAF field. If j* is the
    launchpad we enqueue locally; otherwise one bounce. The whole round is the
    ``utility_topk_address`` hot-path op (one kernel launch on CUDA).
    """
    st, node, zone, timer, patience, counts = hotpath.utility_topk_address(cfg, s, d, view)
    m = s.metrics
    m = m._replace(
        op_eval=m.op_eval + counts[0],
        op_bounce=m.op_bounce + counts[1],
        fastfail=m.fastfail + counts[2],
    )
    return s._replace(
        st=st, node=node, zone=zone, timer=timer, patience=patience, metrics=m
    )
