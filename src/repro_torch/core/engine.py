"""The Laminar engine: tick-synchronous composition of all subsystems.

A port of ``repro.core.engine``. One tick is one call of the step
function; a run is a Python loop over ticks. The hot path per tick mirrors
the paper's control path:

    memory dynamics -> runtime control (Airlock / OOM) -> Airlock
    transitions -> completions -> scenario disruption -> node-view build ->
    Z-HAF reports -> TEG refresh -> arrivals -> probe movement
    (+ regeneration) -> TEG dispatch -> DA addressing -> node arbitration
    (arb_rounds rounds in one launch: bitmap_fit_rounds on the flat tick,
    bitmap_fit_rounds_blocked on each rank's zone block) -> pending
    stage -> absolute timeout

The tick asks nothing of the host: no ``.item()``, no ``torch.nonzero``, no
boolean-mask indexing, so on CUDA the host only enqueues work. The scenario's
arrival schedule enters through the draws (the Poisson count of tick ``t``);
its disruption process is a stage of the tick.

``run_batch`` runs its seeds in lockstep, as the JAX package runs
``jax.vmap`` over its scan: the tick under ``torch.func.vmap`` over a
leading seed axis of the state and the draws (:meth:`LaminarEngine.
simulate_batch`), each hot-path kernel one launch for all seeds
(``kernels.batching``). So the tick writes in place only into tensors it
made from the state (``new_zeros``, ``new_full``, ``torch.cat``), which
carry the seed axis under ``vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import airlock, arbiter, da, disrupt, hotpath, teg, workload, zhaf
from repro_torch.core.config import NUM_TIERS, TIER_NAMES, LaminarConfig
from repro_torch.core.draws import BatchDraws, Draws, TorchDraws, max_dispatch
from repro_torch.core.state import (
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


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    return dev


class LaminarEngine:
    """Build, run, and summarize Laminar simulations on one device.

    ``device`` defaults to ``"cuda"``, where every hot-path op launches its
    hand-written kernel. Without CUDA it raises, unless the caller asks for
    ``device="cpu"`` (the plain PyTorch versions).
    """

    def __init__(self, cfg: LaminarConfig, device="cuda"):
        self.cfg = cfg
        self.device = _resolve_device(device)

    def init(self, seed: int = 0) -> Tuple[SimState, float]:
        """Initial state on the device and the per-tick arrival intensity."""
        d = init_numpy(self.cfg, seed)
        # host-side float32 sum, as the JAX engine computes it
        free_atoms = float(np.asarray(d["rep_S"]).sum())
        lam = workload.lambda_per_tick(self.cfg, free_atoms)
        return state_from_numpy(d, self.device), lam

    def init_batch(self, seeds: Sequence[int]) -> Tuple[SimState, float]:
        """The initial states of ``seeds`` stacked along a leading seed axis,
        and the per-tick arrival intensity.

        As in the JAX package, the cluster geometry (zones, rigid
        pre-occupancy) and ``lam`` come from ``seeds[0]`` and are shared:
        every seed brings its own randomness through its draws (the JAX
        state's ``key`` and ``sched_key``; this package's state has no key,
        its draws come from each seed's provider). Every row is a real copy,
        since the tick writes."""
        seeds = [int(x) for x in seeds]
        if not seeds:
            raise ValueError("init_batch needs at least one seed")
        s, lam = self.init(seeds[0])
        return _stack(s, len(seeds)), lam

    def config_for(self, scenario=None) -> LaminarConfig:
        """``cfg`` running ``scenario`` (``None``: ``cfg.scenario``), as the
        reference's ``run`` / ``run_batch`` build their step for it."""
        if scenario is None or scenario == self.cfg.scenario:
            return self.cfg
        return dataclasses.replace(self.cfg, scenario=scenario)

    def draws(self, lam: float, num_zones: int, seed: int, scenario=None) -> TorchDraws:
        """The default random-value provider: a generator on the device,
        drawing for ``scenario`` (``None``: ``cfg.scenario``)."""
        return TorchDraws(self.config_for(scenario), lam, num_zones, seed=seed,
                          device=self.device)

    def _plane(self, s: SimState):
        """The node-plane strategy of the tick (``None``: the flat path)."""
        return None

    def _checked_config(self, draws, scenario) -> LaminarConfig:
        """The config running ``scenario``; draws that record another
        scenario (``TorchDraws.scenario``) are refused."""
        cfg = self.config_for(scenario)
        made_for = getattr(draws, "scenario", cfg.scenario)
        if made_for != cfg.scenario:
            raise ValueError(
                f"draws made for scenario {made_for.name!r}, engine runs "
                f"{cfg.scenario.name!r}"
            )
        return cfg

    def simulate(
        self, s: SimState, draws, num_ticks: int, scenario=None
    ) -> Tuple[SimState, torch.Tensor]:
        """Run ``num_ticks`` ticks from ``s``; ``draws.tick(t)`` gives each
        tick's random values. Returns the final state and the (T, 11) int32
        timeseries, both still on the device (nothing waits for it).

        The scenario is ``scenario`` (``None``: ``cfg.scenario``); draws that
        record another one (``TorchDraws.scenario``) are refused."""
        cfg = self._checked_config(draws, scenario)
        step = make_step(cfg, plane=self._plane(s))
        rows = []
        for t in range(num_ticks):
            s, ts = step(s, draws.tick(t))
            rows.append(ts)
        if not rows:
            return s, torch.zeros((0, len(TS_FIELDS)), dtype=torch.int32, device=s.st.device)
        return s, torch.stack(rows)

    def simulate_batch(
        self, sb: SimState, draws, num_ticks: int, scenario=None
    ) -> Tuple[SimState, torch.Tensor]:
        """Run ``num_ticks`` ticks of B seeds in lockstep from ``sb`` (a
        state with a leading seed axis, :meth:`init_batch`); ``draws.tick(t)``
        gives each tick's stacked draws (:class:`BatchDraws`). One tick is
        the flat tick under ``torch.func.vmap``: each hot-path kernel is ONE
        launch for all B seeds. Returns the final batched state and the (B,
        T, 11) int32 timeseries, still on the device.

        The scenario is ``scenario`` (``None``: ``cfg.scenario``); draws made
        for another are refused, as :meth:`simulate` refuses them."""
        cfg = self._checked_config(draws, scenario)
        step = make_step(cfg)
        rows = []
        for t in range(num_ticks):
            d = draws.tick(t)
            sb, ts = torch.func.vmap(step, in_dims=(0, BatchDraws.in_dims(d)))(sb, d)
            rows.append(ts)
        if not rows:
            return sb, sb.st.new_zeros((sb.st.shape[0], 0, len(TS_FIELDS)))
        return sb, torch.stack(rows, dim=1)

    def run(
        self,
        seed: int = 0,
        num_ticks: int | None = None,
        scenario=None,
        draws=None,
    ) -> Dict[str, Any]:
        """One run: ``init`` + ``simulate`` + ``summarize``, under
        ``scenario`` (``None``: ``cfg.scenario``). ``draws`` overrides the
        default generator-backed provider."""
        s, lam = self.init(seed)
        if draws is None:
            draws = self.draws(lam, s.zstart.shape[0], seed, scenario)
        nt = num_ticks if num_ticks is not None else self.cfg.num_ticks
        final, ts = self.simulate(s, draws, nt, scenario)
        out = summarize(self.cfg, final, ts.cpu().numpy())
        out["lambda_per_s"] = lam / self.cfg.dt_ms * 1e3
        return out

    def run_batch(
        self,
        seeds: Sequence[int],
        num_ticks: int | None = None,
        scenario=None,
        draws: Optional[Sequence[Any]] = None,
    ) -> List[Dict[str, Any]]:
        """One ``summarize()`` dict per seed, under ``scenario`` (``None``:
        ``cfg.scenario``). ``draws``: one provider per seed (default: each
        seed's generator-backed provider).

        As in the JAX package, the cluster geometry comes from ``seeds[0]``
        (:meth:`init_batch`) and every seed brings its own randomness; the
        seeds advance in lockstep, one batched tick for all
        (:meth:`simulate_batch`), as the JAX package's one ``vmap``'d scan.
        """
        seeds, draws, nt = self._batch_args(seeds, num_ticks, draws)
        sb, lam = self.init_batch(seeds)
        if draws is None:
            draws = [self.draws(lam, sb.zstart.shape[1], sd, scenario) for sd in seeds]
        final, ts = self.simulate_batch(sb, BatchDraws(draws), nt, scenario)
        ts = ts.cpu().numpy()
        return [self._summary(seed_state(final, i), ts[i], lam, sd)
                for i, sd in enumerate(seeds)]

    def _batch_args(self, seeds, num_ticks, draws):
        """``run_batch``'s checks: the seeds as ints (at least one), one
        provider a seed if given, the tick count."""
        seeds = [int(x) for x in seeds]
        if not seeds:
            raise ValueError("run_batch needs at least one seed")
        if draws is not None and len(draws) != len(seeds):
            raise ValueError(f"run_batch: {len(draws)} draws for {len(seeds)} seeds")
        return seeds, draws, num_ticks if num_ticks is not None else self.cfg.num_ticks

    def _summary(self, final: SimState, ts: np.ndarray, lam: float, seed: int) -> Dict[str, Any]:
        out = summarize(self.cfg, final, ts)
        out["lambda_per_s"] = lam / self.cfg.dt_ms * 1e3
        out["seed"] = seed
        return out


def _stack(s: SimState, B: int) -> SimState:
    """``s`` with a leading axis of ``B`` copies of every tensor."""
    def rep(x):
        return x.unsqueeze(0).repeat((B,) + (1,) * x.dim())

    return SimState(*(rep(x) for x in s[:-1]), Metrics(*(rep(x) for x in s.metrics)))


def seed_state(sb: SimState, i: int) -> SimState:
    """Seed ``i``'s state out of a batched state (views)."""
    return SimState(*(x[i] for x in sb[:-1]), Metrics(*(x[i] for x in sb.metrics)))


def summarize(cfg: LaminarConfig, final: SimState, ts: np.ndarray) -> Dict[str, Any]:
    """Host-side summary of a run (numpy), line for line the JAX package's."""
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
