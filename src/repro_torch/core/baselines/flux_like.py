"""Flux-like: the structure-bound bottleneck (§V-A), a port of
``repro.core.baselines.flux_like``.

A hierarchical broker tree (fanout 16, leaf groups of 32 nodes). Graph
matching cost is removed (optimistic: 1 us/level dispatch, 5 ns leaf scan),
but three topology-level laws are enforced:

  1. root choke point: every dispatch and every re-dispatch passes the root;
     beyond 4,000 concurrent tasks an exponential congestion penalty applies;
  2. isolated ledgers: sibling brokers decide from views refreshed only by the
     10 ms heartbeat -> concurrent placements collide at the leaves;
  3. cascading rollback: a leaf collision cannot resolve laterally; the task
     climbs back toward the root at 0.5 ms/hop + 10 ms backoff per level.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.baselines import common as C
from repro_torch.core import floatops as fo
from repro_torch.core.baselines.draws import LEAF_GROUP, BaselineDraws, num_leaves
from repro_torch.core.config import BaselineConfig, LaminarConfig
from repro_torch.core.engine import _resolve_device

ROOT_BATCH = 256


class FluxState(NamedTuple):
    tt: C.TaskTable
    free: torch.Tensor
    stale_leaf_S: torch.Tensor  # heartbeat view of per-leaf aggregate slack
    carry: torch.Tensor
    t: torch.Tensor
    scen: C.ScenarioState
    metrics: C.BaseMetrics


def levels(cfg: LaminarConfig, bcfg: BaselineConfig) -> int:
    """Depth of the broker tree over the leaf brokers."""
    return max(1, math.ceil(math.log(max(num_leaves(cfg), 2), bcfg.flux_fanout)))


def leaf_slack(cfg: LaminarConfig, free: torch.Tensor) -> torch.Tensor:
    """(n_leaves,) float32 free atoms per leaf broker (whole numbers)."""
    n = num_leaves(cfg)
    true_S = C.slack(cfg, free).to(torch.float32)
    return true_S[: n * LEAF_GROUP].reshape(n, LEAF_GROUP).sum(dim=-1)


def choke(bcfg: BaselineConfig, in_system: torch.Tensor) -> torch.Tensor:
    """The root's congestion factor ``exp(-max(0, n - choke) / scale)``, with
    the reference's reciprocal multiply and XLA's float32 ``exp``."""
    over = torch.clamp(in_system - fo.f32(bcfg.flux_root_choke), min=0.0)
    return fo.exp(-over * fo.recip(bcfg.flux_root_choke_scale))


def make_step(cfg: LaminarConfig, bcfg: BaselineConfig):
    """Build ``step(state, draws) -> (state', (arrived, started, completed))``.
    The arrival intensity enters through the draws' Poisson count."""
    N = cfg.num_nodes
    depth = levels(cfg, bcfg)
    hb = cfg.ticks(bcfg.heartbeat_ms)
    base_rate = fo.f32((cfg.dt_ms * 1e3) / (depth * bcfg.flux_dispatch_us_per_level))
    # rollback ticks per level climbed: the reference folds ms-per-level
    # over dt into one float32 constant
    rb_ticks = fo.f32(fo.f32(bcfg.flux_rollback_hop_ms + bcfg.flux_backoff_ms_per_level)
                      * fo.recip(cfg.dt_ms))

    def step(s: FluxState, d: BaselineDraws) -> Tuple[FluxState, torch.Tensor]:
        tt, free, m, scen = s.tt, s.free, s.metrics, s.scen

        tt, free, m = C.complete(cfg, tt, free, m)
        scen, tt, free, m = C.scenario_tick(cfg, scen, tt, free, m, s.t, d)
        tt, m, new = C.inject(cfg, tt, m, d, s.t)
        # new arrivals wait at the root (shard == -1 marks "awaiting dispatch")
        tt = tt._replace(shard=torch.where(new, -1, tt.shard))

        # rollback / dispatch hops in flight
        moving = (tt.st == C.B_MOVING) | (tt.st == C.B_BACKOFF)
        timer = torch.where(moving, tt.timer - 1, tt.timer)
        done_move = (tt.st == C.B_MOVING) & (timer <= 0)
        done_back = (tt.st == C.B_BACKOFF) & (timer <= 0)  # back at root level
        tt = tt._replace(
            st=torch.where(done_move | done_back, C.B_QUEUED, tt.st),
            shard=torch.where(done_back, -1, tt.shard),
            timer=timer,
        )

        # --- root dispatch under the choke ------------------------------------
        in_system = C.count((tt.st != C.B_EMPTY) & (tt.st != C.B_RUNNING))
        carry = fo.fma(choke(bcfg, in_system.to(torch.float32)), base_rate, s.carry)
        budget = torch.clamp(torch.floor(carry), max=ROOT_BATCH).to(torch.int32)
        carry = carry - budget.to(torch.float32)

        at_root = (tt.st == C.B_QUEUED) & (tt.shard == -1)
        sel = C.select_oldest(at_root, tt.arrival, ROOT_BATCH, budget)

        # pick a leaf from the heartbeat-stale per-leaf slack (gumbel-softmax)
        logits = fo.log1p(torch.clamp(s.stale_leaf_S, min=0.0))
        leaf = torch.argmax(logits[None, :] + d.leaf_gumbel, dim=-1).to(torch.int32)
        # node within leaf group chosen by the leaf broker (uniform; its own
        # 32-node ledger is scanned at 5 ns -- cost negligible)
        node = torch.clamp(leaf * LEAF_GROUP + d.leaf_off, 0, N - 1)
        tt = tt._replace(
            shard=torch.where(sel, leaf, tt.shard),
            node=torch.where(sel, node, tt.node),
            st=torch.where(sel, C.B_MOVING, tt.st),
            timer=torch.where(sel, 1, tt.timer),  # one hop down
        )

        # --- leaf arbitration: collisions roll back up the tree ----------------
        at_leaf = (tt.st == C.B_QUEUED) & (tt.shard >= 0)
        tt, free, m, admit, reject = C.admit_fifo(cfg, tt, free, at_leaf, s.t, m)
        climb = torch.clamp(tt.retries + 1, max=depth).to(torch.float32)
        back = torch.clamp(torch.round(climb * rb_ticks).to(torch.int32), min=1)
        tt = tt._replace(
            st=torch.where(reject, C.B_BACKOFF, tt.st),
            timer=torch.where(reject, back, tt.timer),
            retries=torch.where(reject, tt.retries + 1, tt.retries),
        )
        m = m._replace(rollbacks=m.rollbacks + C.count(reject))

        # --- heartbeat refresh of leaf aggregate slack --------------------------
        stale_leaf_S = torch.where((s.t % hb) == 0, leaf_slack(cfg, free), s.stale_leaf_S)

        tt, m = C.expire(cfg, bcfg, tt, m, s.t)
        s = FluxState(tt, free, stale_leaf_S, carry, s.t + 1, scen, m)
        return s, torch.stack([m.arrived, m.started, m.completed])

    return step


def init(cfg: LaminarConfig, seed: int = 0, capacity: int = 1 << 16, device="cuda"):
    """The initial state on ``device`` and the per-tick arrival intensity."""
    dev = _resolve_device(device)
    free, lam = C.init_cluster(cfg, seed, dev)
    s = FluxState(
        tt=C.TaskTable.empty(capacity, free.shape[1], dev),
        free=free,
        stale_leaf_S=leaf_slack(cfg, free),
        carry=torch.zeros((), dtype=torch.float32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        scen=C.scenario_init(cfg, free),
        metrics=C.BaseMetrics.zeros(dev),
    )
    return s, lam


def run(cfg: LaminarConfig, bcfg: BaselineConfig | None = None, seed: int = 0,
        capacity: int = 1 << 16, num_ticks: int | None = None, device="cuda", draws=None):
    """One run and its summary. ``device`` defaults to ``"cuda"`` and
    raises without it unless ``device="cpu"``; ``draws`` overrides the
    generator-backed provider on the device."""
    return C.run_model("flux", init, make_step, cfg, bcfg, seed, capacity, num_ticks,
                       device, draws)
