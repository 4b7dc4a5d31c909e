"""One tick of the engine, its initial state and its summary, in plain PyTorch.

A frozen copy of the port's ``core.engine`` (``make_step``, the arrivals,
``summarize``) without its compiled run: the tick is called eagerly, one
seed at a time, and every hot-path entry is its plain version
(``hotpath``). The tick order is the paper's control path:

    memory dynamics -> runtime control (Airlock / OOM) -> Airlock
    transitions -> completions -> scenario disruption -> node-view build ->
    Z-HAF reports -> TEG refresh -> arrivals -> probe movement
    (+ regeneration) -> TEG dispatch -> DA addressing -> node arbitration
    -> pending stage -> absolute timeout
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import airlock, arbiter, da, disrupt, hotpath, teg, workload, zhaf
from .config import NUM_TIERS, TIER_NAMES, LaminarConfig
from .draws import Draws, max_dispatch
from .state import (
    EMPTY,
    LOST_WAIT,
    METRIC_VECTOR_FIELDS,
    RUNNING,
    SUSPENDED,
    Metrics,
    SimState,
    count,
    hist_quantile,
    init_numpy,
    state_from_numpy,
    state_to_numpy,
)
TS_FIELDS = (
    "arrived",
    "started",
    "completed",
    "oom_kill_l",
    "oom_kill_f",
    "reclaimed",
    "fastfail",
    "suspended_cnt",
    "resumed_insitu",
    "migrated",
    "timeout",
)


def _inject_arrivals(
    cfg: LaminarConfig, s: SimState, d: Draws
) -> Tuple[SimState, torch.Tensor]:
    """Write the tick's Poisson batch into free probe slots: the i-th arrival
    goes to the i-th free slot (``teg.compact``, no host sync)."""
    batch = workload.sample_arrivals(cfg, d)
    n_max = cfg.max_arrivals_per_tick
    P = s.st.shape[0]
    dev = s.st.device

    want = torch.arange(n_max, dtype=torch.int32, device=dev) < batch.n
    slots = teg.compact(s.st == EMPTY, n_max)
    ok = want & (slots >= 0)
    # scatters drop invalid rows (clamping to 0 could clobber slot 0)
    tgt = torch.where(ok, slots, P)

    mc = cfg.memory
    oc = (d.oc_u < mc.overclaim_prob).to(torch.float32) * d.oc_v * mc.overclaim_max
    mem = batch.mass.to(torch.float32) * (1.0 + oc) * mc.mem_per_atom
    mem = mem / cfg.atoms_per_node  # fraction of node capacity

    def put(arr, val):
        return teg.scatter_rows(arr, tgt, val)

    s = s._replace(
        contig=put(s.contig, batch.contig),
        squat=put(s.squat, batch.squat),
        tier=put(s.tier, batch.tier),
        migrating=put(s.migrating, False),
        mass=put(s.mass, batch.mass),
        ev=put(s.ev, batch.ev),
        patience=put(s.patience, batch.patience),
        deposit=put(s.deposit, 0.0),
        pull_dur=put(s.pull_dur, batch.pull),
        pull_deadline=put(s.pull_deadline, 0),
        surv_deadline=put(s.surv_deadline, 0),
        arrival=put(s.arrival, s.t.expand(n_max)),
        start=put(s.start, -1),
        service=put(s.service, batch.service),
        regen=put(s.regen, 0),
        mem=put(s.mem, mem),
        alloc=put(s.alloc, 0),
        alloc_node=put(s.alloc_node, -1),
        alloc2=put(s.alloc2, 0),
        node2=put(s.node2, -1),
    )

    mask = teg.scatter_rows(torch.zeros_like(s.migrating), tgt, True)
    n_ok = count(ok)
    n_f = count(ok & ~batch.contig)
    m = s.metrics
    m = m._replace(
        arrived=m.arrived + n_ok,
        arrived_f=m.arrived_f + n_f,
        arrived_l=m.arrived_l + (n_ok - n_f),
        arrived_squat=m.arrived_squat + count(ok & batch.squat),
        dropped_capacity=m.dropped_capacity + (batch.n - n_ok),
    )
    return s._replace(metrics=m), mask


def make_step(cfg: LaminarConfig, plane=None):
    """Build the one-tick transition ``step(s, draws) -> (s', ts)``.

    ``ts`` is the (len(TS_FIELDS),) int32 vector of cumulative counters.
    The tick runs ``cfg.scenario``. Its arrival rate, scheduled or not,
    enters through the draws (their Poisson count), which must be made for
    the same scenario.

    ``plane`` selects the node-plane strategy. ``None`` runs the flat
    single-device path. The zone-sharded engine
    (``repro_torch.parallel.engine_mesh``) passes a ``MeshPlane``: the
    per-node bitmap pipeline (view build, feasibility, allocation, zone
    aggregation) then runs on each rank's zone block, while the probe table
    and every O(N) float vector stay replicated.
    """
    scenario = cfg.scenario
    disruption_on = scenario.disruption.enabled
    n_dispatch = max_dispatch(cfg)
    # the ambient noise's scale: a host constant, computed once, out of the tick
    noise = airlock.noise_scale(cfg.memory) if cfg.memory.enabled else None

    def step(s: SimState, d: Draws) -> Tuple[SimState, torch.Tensor]:
        # ---- runtime survival (Exp5) ---------------------------------------
        if cfg.memory.enabled:
            s = airlock.memory_dynamics(cfg, s, d, noise)
            # one fused pass over the probe table: pressure + victim +
            # transition masks (survival_scan kernel or its plain version)
            pressure, victim, resume, react, expire = hotpath.survival_scan(cfg, s)
            s = airlock.runtime_control(cfg, s, victim)
            s, react_mask = airlock.airlock_transitions(cfg, s, resume, react, expire)
        else:
            pressure = s.amb.new_zeros(cfg.num_nodes)
            react_mask = torch.zeros_like(s.migrating)

        # ---- service progress ------------------------------------------------
        s = arbiter.completions(cfg, s)

        # ---- scenario disruption: fail/drain/recover nodes --------------------
        if disruption_on:
            s, evict_mask = disrupt.apply(cfg, scenario, s, d)

        # ---- true node state, computed once per tick ---------------------------
        view = zhaf.build_view(cfg, s) if plane is None else plane.build_view(cfg, s)

        # ---- cold path: state dissemination -------------------------------
        s = zhaf.report(cfg, s, d, view)
        s = teg.refresh(cfg, s, plane)

        # ---- admissions hot path ----------------------------------------------
        s, arrival_mask = _inject_arrivals(cfg, s, d)
        s, regen_mask = da.move(cfg, s, d)
        dispatch_mask = arrival_mask | regen_mask | react_mask
        if disruption_on:
            dispatch_mask = dispatch_mask | evict_mask
        s = teg.dispatch(cfg, s, d, dispatch_mask, n_dispatch)
        s = da.address(cfg, s, d, view)

        if cfg.memory.enabled and cfg.airlock:
            throttled = pressure > cfg.memory.high_watermark
        else:
            throttled = s.node_up.new_zeros(cfg.num_nodes)
        # multiple admission rounds per tick: after each reservation the node
        # removes the winner's atoms and proceeds to the next feasible
        # candidate; one launch runs them all, on every node or on the
        # rank's zone block
        if plane is None:
            s = arbiter.arbitrate_rounds(cfg, s, throttled)
        else:
            s = plane.arb_rounds(cfg, s, throttled)
        s = arbiter.pending_stage(cfg, s)
        s = arbiter.timeouts(cfg, s)

        s = s._replace(t=s.t + 1)
        ts = torch.stack([getattr(s.metrics, f) for f in TS_FIELDS])
        return s, ts

    return step


def init(cfg: LaminarConfig, seed: int, device) -> Tuple[SimState, float]:
    """Initial state on ``device`` and the per-tick arrival intensity, as
    the port's ``LaminarEngine.init`` makes them."""
    d = init_numpy(cfg, seed)
    free_atoms = float(np.asarray(d["rep_S"]).sum())
    lam = workload.lambda_per_tick(cfg, free_atoms)
    return state_from_numpy(d, torch.device(device)), lam


def seed_state(sb: SimState, i: int) -> SimState:
    """Seed ``i``'s state out of a batched state (views)."""
    return SimState(*(x[i] for x in sb[:-1]), Metrics(*(x[i] for x in sb.metrics)))


def summarize(cfg: LaminarConfig, final: SimState, ts: np.ndarray) -> Dict[str, Any]:
    """Host-side summary of a run (numpy)."""
    fin = state_to_numpy(final)
    m = fin["metrics"]
    arrived = max(int(m["arrived"]), 1)
    started = max(int(m["started"]), 1)

    # horizon censoring: control probes still in flight at the end of the run
    st = fin["st"]
    mig = fin["migrating"]
    squat = fin["squat"]
    ctl = (((st > EMPTY) & (st < RUNNING)) | (st == LOST_WAIT)) & ~mig
    in_flight = int(ctl.sum())
    in_flight_nonsquat = int((ctl & ~squat).sum())
    # started tasks still alive at the horizon
    resident_mask = ((st == RUNNING) | (st == SUSPENDED)) | (mig & (st != EMPTY))
    resident_end = int(resident_mask.sum())

    hist = np.asarray(m["lat_hist"], np.float64)
    total = hist.sum()
    if total > 0:
        p50 = hist_quantile(hist, 0.50)
        p99 = hist_quantile(hist, 0.99)
    else:
        p50 = p99 = float("nan")

    k = cfg.candidate_k
    work_ns = (
        float(m["op_dispatch"]) * cfg.ns_utility_score
        + float(m["op_eval"]) * (cfg.ns_utility_score + k * cfg.ns_bitmap_check)
        + float(m["op_bounce"]) * cfg.ns_bitmap_check
        + float(m["op_arb"]) * cfg.ns_bitmap_check
        + float(m["op_dispatch"]) * cfg.ns_zone_aggregate * 0.0  # cold path excluded
    )

    probe_drops = (
        int(m["fastfail"])
        + int(m["lost"])
        + int(m["regen_exhausted"])
        + int(m["timeout"])
        + int(m["reclaimed"])
        + int(m["reserve_expired"])
    )

    out: Dict[str, Any] = {
        f: int(m[f]) for f in Metrics._fields if f not in METRIC_VECTOR_FIELDS
    }

    # ---- per-tier lifecycle accounting (Exp8) -----------------------------
    tier = fin["tier"]
    resident_tier = np.bincount(tier[resident_mask], minlength=NUM_TIERS)[:NUM_TIERS]
    for i, nm in enumerate(TIER_NAMES):
        started_i = int(m["started_tier"][i])
        killed_i = (
            int(m["oom_kill_tier"][i])
            + int(m["reclaimed_tier"][i])
            + int(m["evicted_killed_tier"][i])
        )
        th = np.asarray(m["lat_hist_tier"][i], np.float64)
        out[f"{nm}_started"] = started_i
        out[f"{nm}_completed"] = int(m["completed_tier"][i])
        out[f"{nm}_oom"] = int(m["oom_kill_tier"][i])
        out[f"{nm}_reclaimed"] = int(m["reclaimed_tier"][i])
        out[f"{nm}_evicted_killed"] = int(m["evicted_killed_tier"][i])
        out[f"{nm}_resident_end"] = int(resident_tier[i])
        out[f"{nm}_survival"] = 1.0 - killed_i / max(started_i, 1)
        out[f"{nm}_p50_ms"] = hist_quantile(th, 0.50) if th.sum() > 0 else float("nan")
        out[f"{nm}_p99_ms"] = hist_quantile(th, 0.99) if th.sum() > 0 else float("nan")

    out.update(
        start_success_ratio=float(m["started"]) / max(arrived - in_flight, 1),
        start_success_raw=float(m["started"]) / arrived,
        # squatters never intend to start; Exp4's ratio excludes them
        start_success_nonsquat=float(m["started"])
        / max(arrived - int(m["arrived_squat"]) - in_flight_nonsquat, 1),
        in_flight_end=in_flight,
        resident_end=resident_end,
        completed_success_ratio=float(m["completed"]) / max(arrived - in_flight, 1),
        # every way a started task dies: kernel OOM, Airlock reclamation, or
        # an un-airlocked hard node failure (evicted_killed)
        exec_survival_ratio=1.0
        - (
            float(m["oom_kill_f"] + m["oom_kill_l"])
            + float(m["reclaimed"])
            + float(m["evicted_killed"])
        )
        / started,
        p50_ms=p50,
        p99_ms=p99,
        control_us_per_start=work_ns / started / 1e3,
        probe_drops=probe_drops,
        lat_hist=hist,
        timeseries={f: ts[:, i] for i, f in enumerate(TS_FIELDS)},
    )
    return out
