"""Shared substrate for the three optimistic baseline models (§V-A), a port
of ``repro.core.baselines.common``.

All baselines share Laminar's cluster geometry, rigid pre-occupancy, bitmap
allocation machinery, open-loop workload, network ground rules (0.5 ms hop,
10 ms heartbeat) and metrics; only the control path differs. Engineering
inefficiencies of the real systems (etcd fsync, TCP retransmit, GCS
serialization) are deliberately *omitted*: each model is optimistic in favor
of the baseline, so any gap favoring Laminar is a lower bound.

As in the engine's port, a step takes its random values as one
:class:`~repro_torch.core.baselines.draws.BaselineDraws` (the scenario's
arrival schedule enters through their Poisson count) and asks nothing of the
host: fixed-size index buffers (``teg.compact``) and drop-row scatters
(``teg.scatter_rows``) stand where the reference uses ``nonzero(size=)`` and
``.at[].set(mode="drop")``. Bitmap words are int32 bit patterns of the
reference's uint32 words. :func:`state_from_numpy` / :func:`state_to_numpy`
carry a model's state between the two packages as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import bitmap, workload
from repro_torch.core.arbiter import _free_atoms_at
from repro_torch.core.baselines.draws import TorchBaselineDraws
from repro_torch.core.config import NUM_TIERS, TIER_NAMES, BaselineConfig, LaminarConfig
from repro_torch.core.disrupt import disrupted_capacity
from repro_torch.core.scan import scan
from repro_torch.core.state import (
    HIST_BUCKETS,
    count,
    hist_quantile,
    init_numpy,
    latency_bucket,
    tier_counts,
)
from repro_torch.core.teg import compact, scatter_rows
from repro_torch.workloads.disruption import disruption_step

# task states shared by the baseline models
B_EMPTY = 0
B_QUEUED = 1  # waiting in whichever queue the paradigm uses
B_MOVING = 2  # in-flight redirect / dispatch / rollback hop
B_RUNNING = 3
B_BACKOFF = 4  # retry backoff / rollback backoff

NO_AGE = -(1 << 30)  # the age key of a task outside the queue being served


class BaseMetrics(NamedTuple):
    arrived: torch.Tensor
    started: torch.Tensor
    completed: torch.Tensor
    failed: torch.Tensor
    dropped: torch.Tensor
    timeout: torch.Tensor
    retries: torch.Tensor
    spillbacks: torch.Tensor
    rollbacks: torch.Tensor
    # started tasks killed by a hard node failure: the baselines' only
    # post-start death, so it IS their execution-survival numerator. Distinct
    # from ``failed``, which some models also use for pre-start give-ups.
    disrupt_killed: torch.Tensor
    # per-tier lifecycle counters, (NUM_TIERS,) each
    started_tier: torch.Tensor
    completed_tier: torch.Tensor
    disrupt_killed_tier: torch.Tensor
    lat_hist: torch.Tensor
    lat_hist_tier: torch.Tensor  # (NUM_TIERS, HIST_BUCKETS)

    @staticmethod
    def zeros(device) -> "BaseMetrics":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        return BaseMetrics(
            *(z() for _ in range(10)),
            started_tier=z(NUM_TIERS),
            completed_tier=z(NUM_TIERS),
            disrupt_killed_tier=z(NUM_TIERS),
            lat_hist=z(HIST_BUCKETS),
            lat_hist_tier=z(NUM_TIERS, HIST_BUCKETS),
        )


# BaseMetrics fields that are arrays rather than scalar counters
BASE_VECTOR_FIELDS = (
    "started_tier",
    "completed_tier",
    "disrupt_killed_tier",
    "lat_hist",
    "lat_hist_tier",
)


class TaskTable(NamedTuple):
    st: torch.Tensor
    contig: torch.Tensor
    tier: torch.Tensor  # workload class: 0 prod / 1 batch / 2 best-effort
    mass: torch.Tensor
    node: torch.Tensor
    shard: torch.Tensor
    timer: torch.Tensor
    retries: torch.Tensor
    arrival: torch.Tensor
    service: torch.Tensor
    alloc: torch.Tensor  # (P, W) int32 bit patterns of the held atoms
    alloc_node: torch.Tensor

    @staticmethod
    def empty(P: int, W: int, device) -> "TaskTable":
        def zi(fill=0):
            return torch.full((P,), fill, dtype=torch.int32, device=device)

        return TaskTable(
            st=zi(),
            contig=torch.zeros(P, dtype=torch.bool, device=device),
            tier=zi(),
            mass=zi(),
            node=zi(-1),
            shard=zi(),
            timer=zi(),
            retries=zi(),
            arrival=zi(),
            service=zi(),
            alloc=torch.zeros((P, W), dtype=torch.int32, device=device),
            alloc_node=zi(-1),
        )


def init_cluster(cfg: LaminarConfig, seed: int, device) -> Tuple[torch.Tensor, float]:
    """Laminar's painted post-landing cluster: ``(free words, lam)``, the
    per-tick arrival intensity from the host-side float32 sum of the free
    atoms, as the reference computes it."""
    d = init_numpy(cfg, seed)
    lam = workload.lambda_per_tick(cfg, float(np.asarray(d["rep_S"]).sum()))
    free = torch.from_numpy(np.ascontiguousarray(d["free"]).view(np.int32).copy())
    return free.to(device), lam


def slack(cfg: LaminarConfig, free: torch.Tensor) -> torch.Tensor:
    """(N,) int32 free atoms per node, counted over the unpacked bitmap."""
    bits = bitmap.unpack_bits(free, cfg.atoms_per_node)
    return torch.sum(bits, dim=-1, dtype=torch.int32)


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of 1-D ``x``, largest first, the
    lower index first among equal values: ``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise on ties. A stable descending sort keeps
    tied entries in index order."""
    return torch.sort(x, descending=True, stable=True).indices[:k].to(torch.int32)


def select_oldest(pool: torch.Tensor, arrival: torch.Tensor, k: int, budget: torch.Tensor):
    """The ``budget`` (<= ``k``) oldest tasks of ``pool`` as a (P,) mask,
    earliest arrival first, the lower slot first among equal arrivals."""
    P = pool.shape[0]
    age = torch.where(pool, -arrival, NO_AGE)
    idx = top_k(age, k)
    take = torch.arange(k, dtype=torch.int32, device=pool.device) < budget
    sel = scatter_rows(torch.zeros_like(pool), torch.where(take, idx, P), True)
    return sel & pool


# ---------------------------------------------------------------------------
# scenario threading (node disruption): the baselines consume the exact same
# disruption event process as the Laminar engine, and their arrival counts
# come from draws made at the same schedule's rate, so scenario sweeps stay
# head-to-head fair.
# ---------------------------------------------------------------------------


class ScenarioState(NamedTuple):
    """Per-run scenario process state carried through a baseline's run. (The
    reference also carries the arrival-schedule key; here the schedule
    shapes the draws.)"""

    node_up: torch.Tensor  # (N,) bool
    down_until: torch.Tensor  # (N,) i32
    free0: torch.Tensor  # (N, W) painted bitmap (recovery restore base)


def scenario_init(cfg: LaminarConfig, free: torch.Tensor) -> ScenarioState:
    N, dev = cfg.num_nodes, free.device
    return ScenarioState(
        node_up=torch.ones(N, dtype=torch.bool, device=dev),
        down_until=torch.zeros(N, dtype=torch.int32, device=dev),
        free0=free,
    )


def scenario_tick(cfg: LaminarConfig, scen: ScenarioState, tt: TaskTable,
                  free: torch.Tensor, m: BaseMetrics, t: torch.Tensor, d):
    """One scenario tick for a baseline step: the disruption, when the
    scenario enables it. Returns ``(scen, tt, free, m)``: the single call
    every baseline makes, so the threading cannot drift per model."""
    if cfg.scenario.disruption.enabled:
        if d.dis_u is None:
            raise ValueError(
                "disruption is on but the draws carry no disruption values: build "
                "the provider for this scenario"
            )
        scen, tt, free, m = scenario_disrupt(cfg, scen, tt, free, m, t, d.dis_u, d.dis_start)
    return scen, tt, free, m


def scenario_disrupt(cfg: LaminarConfig, scen: ScenarioState, tt: TaskTable,
                     free: torch.Tensor, m: BaseMetrics, t: torch.Tensor,
                     event_u: torch.Tensor, start: torch.Tensor):
    """Apply one disruption tick to a baseline's tables.

    Down nodes advertise zero capacity (every admission against them fails
    and flows into the model's own retry/spillback/rollback path); a hard
    failure kills residents outright (counted as ``failed``: the baselines
    have no survival ladder, which is exactly the contrast Exp6 measures);
    a drain lets residents finish. Recovery restores the painted bitmap
    minus atoms still held by surviving residents.
    """
    dc = cfg.scenario.disruption
    N = cfg.num_nodes
    up, down_until, fail, recover = disruption_step(
        dc, scen.node_up, scen.down_until, t, event_u, start, cfg.dt_ms
    )
    if not dc.drain:
        hit = (tt.alloc_node >= 0) & fail[torch.clamp(tt.alloc_node, 0, N - 1)]
        victim = (tt.st == B_RUNNING) & hit
        n_victim = count(victim)
        m = m._replace(
            failed=m.failed + n_victim,
            disrupt_killed=m.disrupt_killed + n_victim,
            disrupt_killed_tier=m.disrupt_killed_tier + tier_counts(tt.tier, victim),
        )
        tt = tt._replace(
            st=torch.where(victim, B_EMPTY, tt.st),
            alloc=torch.where(victim[:, None], 0, tt.alloc),
            alloc_node=torch.where(victim, -1, tt.alloc_node),
        )
    free = disrupted_capacity(free, scen.free0, up, recover, tt.alloc, tt.alloc_node)
    return ScenarioState(up, down_until, scen.free0), tt, free, m


def inject(cfg: LaminarConfig, tt: TaskTable, m: BaseMetrics, d, t: torch.Tensor):
    """Write the tick's Poisson arrivals into free slots (the i-th arrival to
    the i-th free slot); returns ``(tt, m, new-task mask)``."""
    batch = workload.sample_arrivals(cfg, d)
    n_max = cfg.max_arrivals_per_tick
    P = tt.st.shape[0]
    want = torch.arange(n_max, dtype=torch.int32, device=tt.st.device) < batch.n
    slots = compact(tt.st == B_EMPTY, n_max)
    ok = want & (slots >= 0)
    # scatters drop invalid rows (clamping to 0 could clobber slot 0)
    tgt = torch.where(ok, slots, P)

    def put(arr, val):
        return scatter_rows(arr, tgt, val)

    tt = tt._replace(
        st=put(tt.st, B_QUEUED),
        contig=put(tt.contig, batch.contig),
        tier=put(tt.tier, batch.tier),
        mass=put(tt.mass, batch.mass),
        node=put(tt.node, -1),
        timer=put(tt.timer, 0),
        retries=put(tt.retries, 0),
        arrival=put(tt.arrival, t.expand(n_max)),
        service=put(tt.service, batch.service),
        alloc=put(tt.alloc, 0),
        alloc_node=put(tt.alloc_node, -1),
    )
    mask = scatter_rows(torch.zeros_like(tt.contig), tgt, True)
    n_ok = count(ok)
    m = m._replace(arrived=m.arrived + n_ok, dropped=m.dropped + (batch.n - n_ok))
    return tt, m, mask


def _wrap(idx: torch.Tensor, size: int) -> torch.Tensor:
    """A scatter index as the reference's ``.at[idx]`` reads it: a negative
    index counts from the end."""
    return torch.where(idx < 0, idx + size, idx).long()


def admit_fifo(cfg: LaminarConfig, tt: TaskTable, free: torch.Tensor,
               cand: torch.Tensor, t: torch.Tensor, m: BaseMetrics):
    """Admit one candidate per node (earliest arrival wins), against the
    true bitmap. As in the reference, every candidate whose float32 score
    ``-arrival * 1e3 - slot * 1e-3`` rounds equal to its node's best wins,
    and those all take the allocation made for the highest such slot (from
    arrival tick 9 on, neighbouring slots' scores round equal).
    Returns ``(tt, free, m, admit_mask, reject_mask)``; the start
    counters (global + per-tier) and latency histograms update here, the ONE
    shared admission site, so per-tier accounting cannot drift between the
    three baseline models.
    """
    P = tt.st.shape[0]
    N = cfg.num_nodes
    dev = tt.st.device
    node_c = torch.clamp(tt.node, 0, N - 1)
    slot = torch.arange(P, dtype=torch.int32, device=dev)

    # the reference's score, rounded op by op as its program rounds it
    fifo = -tt.arrival.to(torch.float32) * 1e3 - slot.to(torch.float32) * 1e-3
    score = torch.where(cand, fifo, -torch.inf)
    best = torch.full((N + 1,), -torch.inf, dtype=torch.float32, device=dev)
    best.scatter_reduce_(0, _wrap(torch.where(cand, tt.node, N), N + 1), score, "amax")
    winner = cand & (score == best[torch.clamp(tt.node, 0, N).long()]) & torch.isfinite(score)

    wslot = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    wslot.scatter_reduce_(
        0, _wrap(torch.where(winner, tt.node, N), N + 1), torch.where(winner, slot, -1), "amax"
    )
    has_w = wslot[:N] >= 0
    ws = torch.clamp(wslot[:N], 0, P - 1).long()

    bits = bitmap.unpack_bits(free, cfg.atoms_per_node)
    alloc_bits, feas_n = bitmap.alloc_for_class(
        bits, tt.mass[ws], tt.contig[ws], policy=cfg.alloc_policy
    )
    feas_n = feas_n & has_w
    alloc_words_n = bitmap.pack_bits(alloc_bits & feas_n[:, None])
    free = free & ~alloc_words_n

    admit = winner & feas_n[node_c]
    reject = winner & ~admit

    tt = tt._replace(
        st=torch.where(admit, B_RUNNING, tt.st),
        alloc=torch.where(admit[:, None], alloc_words_n[node_c], tt.alloc),
        alloc_node=torch.where(admit, tt.node, tt.alloc_node),
    )
    b = latency_bucket((t - tt.arrival).to(torch.float32) * cfg.dt_ms)
    one = admit.to(torch.int32)
    hist = m.lat_hist.index_add(0, torch.where(admit, b, 0).long(), one)
    flat = torch.where(admit, tt.tier * HIST_BUCKETS + b, 0).long()
    hist_tier = m.lat_hist_tier.reshape(-1).index_add(0, flat, one).reshape(NUM_TIERS, HIST_BUCKETS)
    m = m._replace(
        started=m.started + count(admit),
        started_tier=m.started_tier + tier_counts(tt.tier, admit),
        lat_hist=hist,
        lat_hist_tier=hist_tier,
    )
    return tt, free, m, admit, reject


def complete(cfg: LaminarConfig, tt: TaskTable, free: torch.Tensor, m: BaseMetrics):
    """Service progress: finished tasks free their atoms and their slot."""
    running = tt.st == B_RUNNING
    service = torch.where(running, tt.service - 1, tt.service)
    done = running & (service <= 0)
    free = _free_atoms_at(free, tt.alloc, tt.alloc_node, done)
    m = m._replace(
        completed=m.completed + count(done),
        completed_tier=m.completed_tier + tier_counts(tt.tier, done),
    )
    tt = tt._replace(
        st=torch.where(done, B_EMPTY, tt.st),
        service=service,
        alloc=torch.where(done[:, None], 0, tt.alloc),
        alloc_node=torch.where(done, -1, tt.alloc_node),
    )
    return tt, free, m


def expire(cfg: LaminarConfig, bcfg: BaselineConfig, tt: TaskTable, m: BaseMetrics,
           t: torch.Tensor, use_timeout: bool = True):
    """Tasks waiting longer than the task timeout leave the system."""
    if not use_timeout:
        return tt, m
    waiting = (tt.st != B_EMPTY) & (tt.st != B_RUNNING)
    late = waiting & ((t - tt.arrival) > cfg.ticks(bcfg.task_timeout_ms))
    m = m._replace(timeout=m.timeout + count(late))
    return tt._replace(st=torch.where(late, B_EMPTY, tt.st)), m


def simulate(step, s, draws, num_ticks: int):
    """Run ``num_ticks`` steps from ``s``; ``draws.tick(t)`` gives each
    tick's random values. Returns the final state and the (T, 3) int32
    cumulative ``(arrived, started, completed)`` series, both still on the
    device (nothing waits for them).

    The run is ``core.scan.scan``, as each reference model's ``run`` is a
    ``jax.jit`` of ``lax.scan`` made for that run: on CUDA the step is
    captured once for this call and replayed every tick, on the CPU the
    same in-place body runs in a loop."""
    if num_ticks == 0:
        return s, torch.zeros((0, 3), dtype=torch.int32, device=s.t.device)
    return scan(step, s, draws, num_ticks)


def run_model(model: str, init, make_step, cfg: LaminarConfig, bcfg, seed: int,
              capacity: int, num_ticks, device, draws) -> Dict[str, object]:
    """A model's ``run``: its ``init`` on ``device`` (``"cuda"`` unless the
    caller asks for the CPU), the generator-backed draws on that device
    unless ``draws`` is given, ``simulate`` and ``summarize_baseline``."""
    bcfg = bcfg or BaselineConfig()
    s, lam = init(cfg, seed, capacity, device)
    if draws is None:
        draws = TorchBaselineDraws(model, cfg, lam, capacity, seed, s.t.device)
    check_draws(draws, model, cfg, capacity)
    nt = num_ticks if num_ticks is not None else cfg.num_ticks
    final, _ = simulate(make_step(cfg, bcfg), s, draws, nt)
    out = summarize_baseline(cfg, final.metrics, final.tt)
    out["lambda_per_s"] = lam / cfg.dt_ms * 1e3
    return out


def check_draws(draws, model: str, cfg: LaminarConfig, capacity: int) -> None:
    """Refuse draws made for another model, scenario or task-table size."""
    for what, made_for, want in (("model", getattr(draws, "model", model), model),
                                 ("scenario", getattr(draws, "scenario", cfg.scenario),
                                  cfg.scenario),
                                 ("capacity", getattr(draws, "capacity", capacity), capacity)):
        if made_for != want:
            name = getattr(made_for, "name", made_for)
            raise ValueError(f"draws made for {what} {name!r}, the run needs "
                             f"{getattr(want, 'name', want)!r}")


def summarize_baseline(cfg: LaminarConfig, m: BaseMetrics, tt: TaskTable) -> Dict[str, object]:
    """Host-side summary of a run (numpy), line for line the reference's."""
    mm = {f: getattr(m, f).detach().cpu().numpy() for f in BaseMetrics._fields}
    arrived = max(int(mm["arrived"]), 1)
    st = tt.st.detach().cpu().numpy()
    in_flight = int(((st != B_EMPTY) & (st != B_RUNNING)).sum())
    hist = np.asarray(mm["lat_hist"], np.float64)
    total = hist.sum()
    if total > 0:
        p50 = hist_quantile(hist, 0.50)
        p99 = hist_quantile(hist, 0.99)
    else:
        p50 = p99 = float("nan")
    started = int(mm["started"])
    out: Dict[str, object] = {
        **{f: int(mm[f]) for f in BaseMetrics._fields if f not in BASE_VECTOR_FIELDS},
        "in_flight_end": in_flight,
        "start_success_ratio": started / max(arrived - in_flight, 1),
        "start_success_raw": started / arrived,
        # offered-load success: queue-capacity drops count against the
        # scheduler ("infinite queuing disabled" -- saturation must show)
        "start_success_total": started / max(arrived + int(mm["dropped"]), 1),
        # mirror of the engine's exec_survival_ratio: node-failure kills are
        # the baselines' only post-start death
        "exec_survival_ratio": 1.0 - int(mm["disrupt_killed"]) / max(started, 1),
        "p50_ms": p50,
        "p99_ms": p99,
    }
    tier_np = tt.tier.detach().cpu().numpy()
    resident_tier = np.bincount(tier_np[st == B_RUNNING], minlength=NUM_TIERS)[:NUM_TIERS]
    for i, nm in enumerate(TIER_NAMES):
        started_i = int(mm["started_tier"][i])
        th = np.asarray(mm["lat_hist_tier"][i], np.float64)
        out[f"{nm}_started"] = started_i
        out[f"{nm}_completed"] = int(mm["completed_tier"][i])
        out[f"{nm}_disrupt_killed"] = int(mm["disrupt_killed_tier"][i])
        out[f"{nm}_resident_end"] = int(resident_tier[i])
        out[f"{nm}_survival"] = 1.0 - int(mm["disrupt_killed_tier"][i]) / max(started_i, 1)
        out[f"{nm}_p50_ms"] = hist_quantile(th, 0.50) if th.sum() > 0 else float("nan")
        out[f"{nm}_p99_ms"] = hist_quantile(th, 0.99) if th.sum() > 0 else float("nan")
    return out


# ---------------------------------------------------------------------------
# bridge: a model's state <-> numpy arrays with the reference's field names
# ---------------------------------------------------------------------------

WORD_FIELDS = ("alloc", "free", "free0")  # uint32 in the reference
NESTED = {"tt": TaskTable, "scen": ScenarioState, "metrics": BaseMetrics}


def state_from_numpy(cls, d: Dict[str, object], device):
    """A state of NamedTuple class ``cls`` (a model's state, or one of
    ``TaskTable``, ``ScenarioState``, ``BaseMetrics``) from numpy arrays
    keyed by the reference's field names (nested dicts for the nested
    tuples, uint32 words). Fields the port does not hold (the PRNG keys) are
    ignored."""
    fields = {}
    for f in cls._fields:
        if f in NESTED:
            fields[f] = state_from_numpy(NESTED[f], d[f], device)
            continue
        x = np.asarray(d[f])
        if f in WORD_FIELDS:
            x = np.ascontiguousarray(x).view(np.int32)
        fields[f] = torch.from_numpy(np.array(x, copy=True)).to(device)
    return cls(**fields)


def state_to_numpy(s) -> Dict[str, object]:
    """A state as numpy arrays with the reference's dtypes (uint32 words)."""
    out: Dict[str, object] = {}
    for f in s._fields:
        x = getattr(s, f)
        if f in NESTED:
            out[f] = state_to_numpy(x)
        else:
            a = x.detach().cpu().numpy()
            out[f] = a.view(np.uint32) if f in WORD_FIELDS else a
    return out
