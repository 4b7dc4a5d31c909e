"""Laminar serving engine: probe-first admission + Airlock preemption for
continuous-batching inference.

The paper names transient inference requests as canonical F-tasks (§II-A);
this module applies Laminar's full discipline to a real serving data plane:

  * requests are DAs: declared priority p, page demand m, E_v = p*m,
    patience budget spent on admission attempts;
  * replicas are nodes: Slack = free KV pages, Heat = queued requests;
    entry-side routing is the TEG rule P(r) ~ 2^(U_r / tau);
  * two-phase landing: page reservation first (TTL-bounded), prefill is the
    payload pull, decode is execution;
  * Airlock: under page pressure the lowest-E_v running sequence is
    suspended (KV offloaded, pages freed), preferred for in-situ resume
    before T_susp, re-addressed to another replica before T_surv (KV pull),
    then reclaimed — the Absolute Priority Guarantee for serving: a
    high-priority sequence is never evicted while lower-priority
    reclaimable sequences exist.

The control plane is host-side (numpy / plain python, as in real serving
systems); the data plane (prefill / batched decode) is PyTorch on the device
through ``repro_torch.models.lm``. A line-for-line port of
``repro.sched.serving``: the same ``np.random.default_rng`` calls in the
same order, so a seed gives the reference's decisions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.sched.paging import PageAllocator


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new: int
    priority: float
    arrival: int
    pages: int = 0  # page demand (filled at submit)
    ev: float = 0.0
    patience: float = 0.0
    # lifecycle
    state: str = "queued"  # queued|reserved|running|suspended|migrating|done|failed
    replica: int = -1
    slot: int = -1
    generated: int = 0
    page_idx: Optional[np.ndarray] = None
    reserve_deadline: int = 0
    susp_tick: int = 0
    surv_deadline: int = 0
    started_at: int = -1
    finished_at: int = -1


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    page_size: int = 16  # tokens per KV page
    pages_per_replica: int = 256
    max_slots: int = 8  # concurrent sequences per replica batch
    teg_tau: float = 1.0
    gamma: float = 1.0
    eval_cost: float = 3.0
    fastfail_floor: float = 1.0
    reserve_ttl: int = 8  # ticks allowed between reservation and prefill
    high_watermark: float = 0.90  # page-pool pressure triggering Airlock
    safe_watermark: float = 0.75
    t_susp: int = 8  # ticks preferring in-situ resume
    t_surv: int = 24  # shared survival TTL after reactivation
    airlock: bool = True


class ReplicaState:
    def __init__(self, cfg: ServeConfig):
        self.pages = PageAllocator(cfg.pages_per_replica)
        self.slots: List[Optional[int]] = [None] * cfg.max_slots  # rid per slot
        self.queue: List[int] = []  # rids awaiting arbitration

    @property
    def heat(self) -> int:
        return len(self.queue)


class LaminarServingScheduler:
    """Control plane only — data-plane hooks are injected by the server."""

    def __init__(self, cfg: ServeConfig, num_replicas: int, seed: int = 0):
        self.cfg = cfg
        self.replicas = [ReplicaState(cfg) for _ in range(num_replicas)]
        self.requests: Dict[int, Request] = {}
        self.rng = np.random.default_rng(seed)
        self.t = 0
        self._next_rid = 0
        self.stats = dict(
            arrived=0, started=0, completed=0, fastfail=0, suspended=0,
            resumed_insitu=0, migrated=0, reclaimed=0, preempt_denied=0,
        )

    # ---- TEG: entry-side probabilistic routing ---------------------------
    def _route(self, req: Request) -> int:
        u = []
        for r in self.replicas:
            s = r.pages.free_pages
            h = r.heat
            u.append(math.log2(1 + s) - self.cfg.gamma * math.log2(1 + h))
        logits = np.asarray(u) / self.cfg.teg_tau * math.log(2)
        g = self.rng.gumbel(size=len(logits))
        return int(np.argmax(logits + g))

    def submit(self, prompt_len: int, max_new: int, priority: float) -> int:
        rid = self._next_rid
        self._next_rid += 1
        pages = -(-(prompt_len + max_new) // self.cfg.page_size)
        req = Request(
            rid=rid, prompt_len=prompt_len, max_new=max_new,
            priority=priority, arrival=self.t, pages=pages,
            ev=priority * pages, patience=priority * pages,
        )
        self.requests[rid] = req
        self.stats["arrived"] += 1
        rep = self._route(req)
        req.replica = rep
        self.replicas[rep].queue.append(rid)
        return rid

    # ---- node arbitration + two-phase reservation ------------------------
    def _arbitrate(self, actions: Dict[str, list]):
        for ri, rep in enumerate(self.replicas):
            if not rep.queue:
                continue
            # pressure check: halt admission under Airlock pressure
            if (
                self.cfg.airlock
                and rep.pages.utilization() > self.cfg.high_watermark
            ):
                self._reverse_recursive_suspend(ri, actions)
                continue
            # winner by E_v among queued
            rep.queue.sort(key=lambda rid: -self.requests[rid].ev)
            rid = rep.queue[0]
            req = self.requests[rid]
            slot = next((i for i, s in enumerate(rep.slots) if s is None), None)
            pages = (
                rep.pages.alloc(req.pages)
                if slot is not None and rep.pages.free_pages >= req.pages
                else None
            )
            if pages is None:
                # infeasible winner: bounded re-address (bounce to another
                # replica), patience pays for the action
                req.patience -= self.cfg.eval_cost
                rep.queue.pop(0)
                if req.patience < self.cfg.fastfail_floor:
                    req.state = "failed"
                    self.stats["fastfail"] += 1
                else:
                    nxt = self._route(req)
                    req.replica = nxt
                    self.replicas[nxt].queue.append(rid)
                continue
            # two-phase: reservation now, prefill = payload pull
            rep.queue.pop(0)
            rep.slots[slot] = rid
            req.slot = slot
            req.page_idx = pages
            req.state = "reserved"
            req.reserve_deadline = self.t + self.cfg.reserve_ttl
            actions["prefill"].append(rid)

    # ---- Airlock: reverse-recursive suspension ----------------------------
    def _reverse_recursive_suspend(self, ri: int, actions: Dict[str, list]):
        rep = self.replicas[ri]
        running = [
            self.requests[rid]
            for rid in rep.slots
            if rid is not None and self.requests[rid].state == "running"
        ]
        if not running:
            self.stats["preempt_denied"] += 1
            return
        victim = min(running, key=lambda r: r.ev)
        victim.state = "suspended"
        victim.susp_tick = self.t
        rep.pages.release(victim.page_idx)
        rep.slots[victim.slot] = None  # slot freed; KV offloaded (glass-state)
        actions["suspend"].append(victim.rid)
        self.stats["suspended"] += 1

    def _airlock_transitions(self, actions: Dict[str, list]):
        cfg = self.cfg
        for req in list(self.requests.values()):
            if req.state == "suspended":
                rep = self.replicas[req.replica]
                if (
                    rep.pages.utilization() < cfg.safe_watermark
                    and self.t - req.susp_tick <= cfg.t_susp
                ):
                    # in-situ resume: re-pin pages at the source replica
                    slot = next(
                        (i for i, s in enumerate(rep.slots) if s is None), None
                    )
                    pages = (
                        rep.pages.alloc(req.pages)
                        if slot is not None
                        and rep.pages.free_pages >= req.pages
                        else None
                    )
                    if pages is not None:
                        rep.slots[slot] = req.rid
                        req.slot, req.page_idx = slot, pages
                        req.state = "running"
                        actions["restore"].append(req.rid)
                        self.stats["resumed_insitu"] += 1
                        continue
                if self.t - req.susp_tick > cfg.t_susp:
                    # threshold-triggered secondary reactivation
                    req.state = "migrating"
                    req.patience = req.ev  # fresh budget
                    req.surv_deadline = self.t + cfg.t_surv
                    nxt = self._route(req)
                    req.replica = nxt
                    self.replicas[nxt].queue.append(req.rid)
            elif req.state == "migrating" and self.t > req.surv_deadline:
                # bounded reclamation of task + DA
                self._drop(req)
                req.state = "failed"
                self.stats["reclaimed"] += 1
                actions["reclaim"].append(req.rid)

    def _drop(self, req: Request):
        for rep in self.replicas:
            if req.rid in rep.queue:
                rep.queue.remove(req.rid)
        if req.slot >= 0 and self.replicas[req.replica].slots[req.slot] == req.rid:
            self.replicas[req.replica].slots[req.slot] = None
        if req.page_idx is not None and req.state in ("reserved", "running"):
            self.replicas[req.replica].pages.release(req.page_idx)
        req.page_idx = None

    # ---- per-tick control decisions ---------------------------------------
    def tick(self) -> Dict[str, list]:
        """Advance one control tick; returns data-plane actions:
        {prefill: [rid], suspend: [rid], restore: [rid], reclaim: [rid]}."""
        actions: Dict[str, list] = {
            "prefill": [], "suspend": [], "restore": [], "reclaim": []
        }
        self._airlock_transitions(actions)
        self._arbitrate(actions)
        # reservation expiry (squatters / slow prefill)
        for req in self.requests.values():
            if req.state == "reserved" and self.t > req.reserve_deadline:
                self._drop(req)
                req.state = "queued"
                nxt = self._route(req)
                req.replica = nxt
                self.replicas[nxt].queue.append(req.rid)
        self.t += 1
        return actions

    # ---- data-plane callbacks ---------------------------------------------
    def on_prefill_done(self, rid: int):
        req = self.requests[rid]
        if req.state == "reserved":
            req.state = "running"
            req.started_at = self.t
            self.stats["started"] += 1
        elif req.state == "migrating":
            # destination reservation-to-pull completed within T_surv
            req.state = "running"
            self.stats["migrated"] += 1

    def on_token(self, rid: int):
        req = self.requests[rid]
        req.generated += 1
        if req.generated >= req.max_new:
            req.state = "done"
            req.finished_at = self.t
            self._drop_finished(req)
            self.stats["completed"] += 1

    def _drop_finished(self, req: Request):
        rep = self.replicas[req.replica]
        if req.slot >= 0 and rep.slots[req.slot] == req.rid:
            rep.slots[req.slot] = None
        if req.page_idx is not None:
            rep.pages.release(req.page_idx)
        req.page_idx = None

    def running(self, replica: int) -> List[int]:
        return [
            rid
            for rid in self.replicas[replica].slots
            if rid is not None and self.requests[rid].state == "running"
        ]
