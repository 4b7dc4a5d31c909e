"""Apply scenario node-disruption events to the engine state.

A port of ``repro.core.disrupt``. The event process (which nodes fail or
recover each tick) is ``repro_torch.workloads.disruption.disruption_step``;
this module owns the consequences in the engine's tables:

  capacity   a down node advertises zero capacity (its free words zeroed).
             Recovery restores the painted bitmap minus the atoms still held
             by live tasks (``free0 & ~held``).

  residents  a hard failure (``drain=False``) destroys node-local state. With
             Airlock on, residents are forced into the secondary
             re-addressing epoch (fresh E_patience, shared survival TTL, TEG
             re-dispatch this tick); their atoms are lost with the node. With
             Airlock off they are killed outright (``evicted_killed``). A
             graceful drain leaves residents running.

  reservations  a primary reservation on a failed node loses its atoms and
             returns to kinetic addressing (deposit forfeited); a migration
             landing on a failed node reverts to glass-state and re-enters TEG.

It runs after ``arbiter.completions`` and before the node view is built, on
the flat (N, W) words and integer scatters only, so the sharded engine runs
it replicated and builds its blocked plane from the words it leaves.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.config import LaminarConfig
from repro_torch.core.draws import Draws
from repro_torch.core.state import (
    ADDRESSING,
    EMPTY,
    RESERVED,
    RUNNING,
    SUSPENDED,
    SimState,
    count,
    scatter_sum,
    tier_counts,
)
from repro_torch.workloads.disruption import disruption_step
from repro_torch.workloads.scenario import ScenarioConfig


def disrupted_capacity(
    free: torch.Tensor,
    free0: torch.Tensor,
    up: torch.Tensor,
    recover: torch.Tensor,
    alloc: torch.Tensor,
    alloc_node: torch.Tensor,
    alloc2: torch.Tensor | None = None,
    node2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Post-disruption free words: zero down nodes, restore recovered ones.

    The held atoms per node are an integer scatter-add
    (``state.scatter_sum``) of the int32 bit patterns of the live
    allocations: they are disjoint per node, so the sum is their OR, and
    integer addition gives the same bits in any order (and the same bits as
    the reference's uint32 adds) on any device.
    """
    N = free.shape[0]
    held = scatter_sum(N, alloc_node, alloc_node >= 0, alloc)
    if alloc2 is not None:
        held = held + scatter_sum(N, node2, node2 >= 0, alloc2)
    free = torch.where(recover[:, None], free0 & ~held, free)
    return torch.where(up[:, None], free, 0)


def apply(
    cfg: LaminarConfig, scenario: ScenarioConfig, s: SimState, d: Draws
) -> Tuple[SimState, torch.Tensor]:
    """One disruption tick; returns ``(state, re-dispatch mask)``.

    The mask marks probes that re-enter the network through TEG this tick
    (Airlock re-addressing of evicted residents and of migration landings
    whose destination died).
    """
    dc = scenario.disruption
    if d.dis_u is None:
        raise ValueError(
            "disruption is on but the draws carry no disruption values: build "
            "the provider for this scenario"
        )
    N = cfg.num_nodes
    up, down_until, fail, recover = disruption_step(
        dc, s.node_up, s.down_until, s.t, d.dis_u, d.dis_start, cfg.dt_ms
    )
    airlock_on = cfg.airlock and cfg.memory.enabled

    st, migrating = s.st, s.migrating
    patience, deposit = s.patience, s.deposit
    surv_deadline, susp_tick = s.surv_deadline, s.susp_tick
    alloc, alloc_node, mem = s.alloc, s.alloc_node, s.mem
    alloc2, node2 = s.alloc2, s.node2
    dispatch = torch.zeros_like(s.migrating)
    m = s.metrics

    if not dc.drain:
        hit1 = (s.alloc_node >= 0) & fail[torch.clamp(s.alloc_node, 0, N - 1)]
        hit2 = (s.node2 >= 0) & fail[torch.clamp(s.node2, 0, N - 1)]
        resident = ((s.st == RUNNING) | (s.st == SUSPENDED)) & hit1
        resv = (s.st == RESERVED) & ~s.migrating & hit1

        if airlock_on:
            # forced secondary re-addressing with a zero source allocation
            st = torch.where(resident, SUSPENDED, st)
            migrating = migrating | resident
            patience = torch.where(resident, s.ev, patience)
            surv_deadline = torch.where(
                resident, s.t + cfg.ticks(cfg.t_surv_ms), surv_deadline
            )
            susp_tick = torch.where(resident, s.t, susp_tick)
            dispatch = dispatch | resident

            # migration landing lost with its destination: back to glass-state
            mig_resv = (s.st == RESERVED) & s.migrating & hit2
            st = torch.where(mig_resv, SUSPENDED, st)
            alloc2 = torch.where(mig_resv[:, None], 0, alloc2)
            node2 = torch.where(mig_resv, -1, node2)
            dispatch = dispatch | mig_resv

            # a migrating incarnation in flight loses its source state when
            # the source dies; the probe keeps flying
            lost_state = resident | (s.migrating & hit1 & ~resident)
        else:
            # no Airlock: displaced residents die with the node
            st = torch.where(resident, EMPTY, st)
            lost_state = resident
            m = m._replace(
                evicted_killed=m.evicted_killed + count(resident),
                evicted_killed_tier=m.evicted_killed_tier + tier_counts(s.tier, resident),
            )

        alloc = torch.where(lost_state[:, None], 0, alloc)
        alloc_node = torch.where(lost_state, -1, alloc_node)
        mem = torch.where(lost_state, 0.0, mem)

        # primary reservation on a dead node: atoms gone, deposit forfeited,
        # back to kinetic addressing
        st = torch.where(resv, ADDRESSING, st)
        alloc = torch.where(resv[:, None], 0, alloc)
        alloc_node = torch.where(resv, -1, alloc_node)
        deposit = torch.where(resv, 0.0, deposit)

        m = m._replace(evicted=m.evicted + count(lost_state))

    free = disrupted_capacity(s.free, s.free0, up, recover, alloc, alloc_node, alloc2, node2)

    m = m._replace(
        node_failures=m.node_failures + count(fail),
        node_recoveries=m.node_recoveries + count(recover),
    )
    s = s._replace(
        node_up=up,
        down_until=down_until,
        st=st,
        migrating=migrating,
        patience=patience,
        deposit=deposit,
        surv_deadline=surv_deadline,
        susp_tick=susp_tick,
        alloc=alloc,
        alloc_node=alloc_node,
        mem=mem,
        alloc2=alloc2,
        node2=node2,
        free=free,
        metrics=m,
    )
    return s, dispatch
