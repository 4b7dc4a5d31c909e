"""Ray-like: the retry-bound bottleneck (§V-A), a port of
``repro.core.baselines.ray_like``.

Local-first placement with global spillback through a sharded GCS. RPC
serialization, actor lifecycle, and GCS transaction latency are removed
(optimistic), but three structural constraints are preserved:

  1. local mutual exclusion -- reservations serialize through a per-node
     commit lock (one commit per node per tick);
  2. state staleness + spillback -- the GCS view refreshes only on the 10 ms
     heartbeat, and every capacity miss costs a 0.5 ms redirect;
  3. USL contention -- 32 GCS shards with 0.5 hotspot skew; beyond 500 queued
     spillbacks a Universal-Scalability-Law penalty reproduces the
     superlinear coherence collapse (the O(MN) RPC amplification of §II).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.baselines import common as C
from repro_torch.core import floatops as fo
from repro_torch.core.baselines.draws import BaselineDraws
from repro_torch.core.config import BaselineConfig, LaminarConfig
from repro_torch.core.engine import _resolve_device

# task.shard: -1 = local queue; 0 = hot GCS shard; 1 = cold GCS shard pool
LOCAL = -1
HOT = 0
COLD = 1

K_HOT = 16
K_COLD = 384


class RayState(NamedTuple):
    tt: C.TaskTable
    free: torch.Tensor
    stale_S: torch.Tensor  # GCS view of per-node slack (heartbeat-refreshed)
    carry_hot: torch.Tensor
    carry_cold: torch.Tensor
    t: torch.Tensor
    scen: C.ScenarioState
    metrics: C.BaseMetrics


def usl_factor(bcfg: BaselineConfig, n_gcs: torch.Tensor) -> torch.Tensor:
    """The USL throughput factor ``1 / (1 + sigma (n-1) + kappa n (n-1))``
    with ``n = max(n_gcs / depth, 1)``, rounded as the reference's program
    rounds it: a reciprocal multiply for ``/ depth`` and both multiply-adds
    fused."""
    n_units = torch.clamp(n_gcs * fo.recip(bcfg.ray_usl_depth), min=1.0)
    n1 = n_units - 1.0
    den = fo.fma(n1, fo.f32(bcfg.ray_usl_sigma), 1.0)
    den = fo.fma(n_units * fo.f32(bcfg.ray_usl_kappa), n1, den)
    return fo.div(1.0, den)


def make_step(cfg: LaminarConfig, bcfg: BaselineConfig):
    """Build ``step(state, draws) -> (state', (arrived, started, completed))``.
    The arrival intensity enters through the draws' Poisson count."""
    hb = cfg.ticks(bcfg.heartbeat_ms)
    # the reference folds the constant factors of both pools' rates
    rate_hot = fo.f32((cfg.dt_ms * 1e3) / bcfg.ray_gcs_us)
    rate_cold = fo.f32(rate_hot * fo.f32(bcfg.ray_gcs_shards - 1))

    def step(s: RayState, d: BaselineDraws) -> Tuple[RayState, torch.Tensor]:
        tt, free, m, scen = s.tt, s.free, s.metrics, s.scen

        tt, free, m = C.complete(cfg, tt, free, m)
        scen, tt, free, m = C.scenario_tick(cfg, scen, tt, free, m, s.t, d)
        tt, m, new = C.inject(cfg, tt, m, d, s.t)

        # new arrivals land on a uniformly random local node (locality prior)
        tt = tt._replace(
            node=torch.where(new, d.local_node, tt.node),
            shard=torch.where(new, LOCAL, tt.shard),
        )

        # redirects in flight
        moving = tt.st == C.B_MOVING
        timer = torch.where(moving, tt.timer - 1, tt.timer)
        tt = tt._replace(
            st=torch.where(moving & (timer <= 0), C.B_QUEUED, tt.st), timer=timer
        )

        # --- local commit attempt (per-node lock: one per node per tick) -----
        local_q = (tt.st == C.B_QUEUED) & (tt.shard == LOCAL)
        tt, free, m, admit, reject = C.admit_fifo(cfg, tt, free, local_q, s.t, m)

        # capacity miss -> spillback to a GCS shard (hotspot skew)
        hot = d.shard_u < bcfg.ray_hotspot_skew
        tt = tt._replace(
            shard=torch.where(reject & hot, HOT, torch.where(reject, COLD, tt.shard)),
            st=torch.where(reject, C.B_QUEUED, tt.st),
        )
        m = m._replace(spillbacks=m.spillbacks + C.count(reject))

        # --- GCS processing with USL penalty ---------------------------------
        gcs_q = (tt.st == C.B_QUEUED) & (tt.shard != LOCAL)
        usl = usl_factor(bcfg, C.count(gcs_q).to(torch.float32))
        carry_hot = fo.fma(usl, rate_hot, s.carry_hot)
        carry_cold = fo.fma(usl, rate_cold, s.carry_cold)
        b_hot = torch.clamp(torch.floor(carry_hot), max=K_HOT).to(torch.int32)
        b_cold = torch.clamp(torch.floor(carry_cold), max=K_COLD).to(torch.int32)
        carry_hot = carry_hot - b_hot.to(torch.float32)
        carry_cold = carry_cold - b_cold.to(torch.float32)

        sel = C.select_oldest(gcs_q & (tt.shard == HOT), tt.arrival, K_HOT, b_hot) | (
            C.select_oldest(gcs_q & (tt.shard == COLD), tt.arrival, K_COLD, b_cold)
        )

        # GCS redirects from the heartbeat-stale view: sample a few candidate
        # nodes and take the first stale-feasible one. A stale hit that is
        # actually full simply re-spills -- exactly Ray's staleness failure.
        rc = d.pick_node
        ok_c = s.stale_S[rc.long()] >= tt.mass[:, None].to(torch.float32)
        first = torch.argmax(ok_c.to(torch.int32), dim=-1)
        pick = torch.gather(rc, 1, first[:, None])[:, 0]
        pick = torch.where(torch.any(ok_c, dim=-1), pick, rc[:, 0])
        tt = tt._replace(
            node=torch.where(sel, pick, tt.node),
            shard=torch.where(sel, LOCAL, tt.shard),
            st=torch.where(sel, C.B_MOVING, tt.st),
            timer=torch.where(sel, cfg.ticks(bcfg.ray_redirect_ms), tt.timer),
            retries=torch.where(sel, tt.retries + 1, tt.retries),
        )
        m = m._replace(retries=m.retries + C.count(sel))

        # --- heartbeat refresh of the GCS view -------------------------------
        true_S = C.slack(cfg, free).to(torch.float32)
        stale_S = torch.where((s.t % hb) == 0, true_S, s.stale_S)

        tt, m = C.expire(cfg, bcfg, tt, m, s.t)
        s = RayState(tt, free, stale_S, carry_hot, carry_cold, s.t + 1, scen, m)
        return s, torch.stack([m.arrived, m.started, m.completed])

    return step


def init(cfg: LaminarConfig, seed: int = 0, capacity: int = 1 << 16, device="cuda"):
    """The initial state on ``device`` and the per-tick arrival intensity."""
    dev = _resolve_device(device)
    free, lam = C.init_cluster(cfg, seed, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    s = RayState(
        tt=C.TaskTable.empty(capacity, free.shape[1], dev),
        free=free,
        stale_S=C.slack(cfg, free).to(torch.float32),
        carry_hot=zero,
        carry_cold=zero,
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
    return C.run_model("ray", init, make_step, cfg, bcfg, seed, capacity, num_ticks,
                       device, draws)
