"""Engine state: a fixed-shape structure of tensors on one device.

A port of ``repro.core.state``. The tick-synchronous engine keeps every
control object (probe / DA) in a slot of a structure-of-arrays table and
expresses node-level work as segmented reductions over those arrays.

``SimState`` has the JAX package's fields, minus the PRNG keys (``key``,
``sched_key``): here the per-tick random values come from a ``Draws``
provider (``core.draws``). Bitmap words (``free``, ``free0``, ``alloc``,
``alloc2``) are int32 bit patterns of the JAX package's uint32 words.
:func:`state_from_numpy` / :func:`state_to_numpy` carry a state between
the two packages as numpy arrays.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core import floatops
from repro_torch.core.config import NUM_TIERS, LaminarConfig
from repro_torch.core.spans import span

# ---------------------------------------------------------------------------
# probe (DA) state machine codes
# ---------------------------------------------------------------------------
EMPTY = 0  # free slot
ROUTING = 1  # dispatched by TEG, in flight to launchpad
ADDRESSING = 2  # at a node, evaluating Z-HAF candidates (kinetic DA)
BOUNCING = 3  # single-hop physical redirection to j*
QUEUED = 4  # in a node's arbitration queue (counts toward Heat)
RESERVED = 5  # won arbitration; two-phase pending stage (payload pull)
RUNNING = 6  # executing; DA is a resident sentinel
SUSPENDED = 7  # Airlock glass-state (in-situ window T_susp)
LOST_WAIT = 8  # control packet lost; awaiting regeneration quiet interval
NUM_STATES = 9

LIVE_CONTROL = (ROUTING, ADDRESSING, BOUNCING, QUEUED, RESERVED, LOST_WAIT)


class Metrics(NamedTuple):
    arrived: torch.Tensor
    arrived_f: torch.Tensor
    arrived_l: torch.Tensor
    arrived_squat: torch.Tensor
    dropped_capacity: torch.Tensor
    started: torch.Tensor
    started_f: torch.Tensor
    started_l: torch.Tensor
    completed: torch.Tensor
    completed_f: torch.Tensor
    completed_l: torch.Tensor
    fastfail: torch.Tensor
    lost: torch.Tensor
    regen_spawned: torch.Tensor
    regen_exhausted: torch.Tensor
    timeout: torch.Tensor
    squat_expired: torch.Tensor
    reserve_expired: torch.Tensor
    infeasible_winner: torch.Tensor
    oom_kill_f: torch.Tensor
    oom_kill_l: torch.Tensor
    suspended_cnt: torch.Tensor
    resumed_insitu: torch.Tensor
    reactivated: torch.Tensor
    migrated: torch.Tensor
    reclaimed: torch.Tensor
    throttled_rounds: torch.Tensor
    node_failures: torch.Tensor
    node_recoveries: torch.Tensor
    evicted: torch.Tensor
    evicted_killed: torch.Tensor
    # control-work op counters (multiplied by ns constants at summary time)
    op_dispatch: torch.Tensor
    op_eval: torch.Tensor
    op_bounce: torch.Tensor
    op_arb: torch.Tensor
    # per-tier lifecycle counters, (NUM_TIERS,) each
    started_tier: torch.Tensor
    completed_tier: torch.Tensor
    oom_kill_tier: torch.Tensor
    reclaimed_tier: torch.Tensor
    evicted_killed_tier: torch.Tensor
    # arrival->start latency histograms (log buckets): global + per-tier
    lat_hist: torch.Tensor
    lat_hist_tier: torch.Tensor  # (NUM_TIERS, HIST_BUCKETS)

    @staticmethod
    def zeros(device, hist_buckets: int = 64) -> "Metrics":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        vec = dict(
            started_tier=z(NUM_TIERS),
            completed_tier=z(NUM_TIERS),
            oom_kill_tier=z(NUM_TIERS),
            reclaimed_tier=z(NUM_TIERS),
            evicted_killed_tier=z(NUM_TIERS),
            lat_hist=z(hist_buckets),
            lat_hist_tier=z(NUM_TIERS, hist_buckets),
        )
        scalars = [f for f in Metrics._fields if f not in vec]
        return Metrics(**{f: z() for f in scalars}, **vec)


# Metrics fields that are arrays rather than scalar counters
METRIC_VECTOR_FIELDS = (
    "started_tier",
    "completed_tier",
    "oom_kill_tier",
    "reclaimed_tier",
    "evicted_killed_tier",
    "lat_hist",
    "lat_hist_tier",
)


def count(mask: torch.Tensor) -> torch.Tensor:
    """Number of set entries of a bool mask, as an int32 scalar tensor."""
    return torch.sum(mask, dtype=torch.int32)


def scatter_sum(
    rows: int, tgt: torch.Tensor, valid: torch.Tensor, upd: torch.Tensor
) -> torch.Tensor:
    """Integer scatter-add: ``out[tgt[i]] += upd[i]`` for each valid slot i,
    ``out`` of ``(rows, *upd.shape[1:])`` zeros; ``tgt`` is read only where
    ``valid``, and must lie in ``[0, rows)`` there.

    Slot i that is not valid adds into a spare row of its own, ``rows + i``,
    and the spare rows are cut off. So no two dropped slots share an address
    of the scatter's atomics, and each row receives only the slots that add
    into it: one spare row shared by all of them would serialise their adds
    on that address (on an H100, ~50 us for 65 536 slots against ~7). Integer
    adds give the same bits in any order, on any device, and a sum of
    disjoint bit patterns is their OR.
    """
    with span("state.scatter_sum"):
        spare = torch.arange(rows, rows + tgt.shape[0], device=tgt.device)
        out = upd.new_zeros((rows + tgt.shape[0],) + tuple(upd.shape[1:]))
        return out.index_add_(0, torch.where(valid, tgt, spare), upd)[:rows]


def tier_counts(tier: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Count masked probes per tier -> (NUM_TIERS,) i32 scatter-add."""
    return scatter_sum(NUM_TIERS, tier, mask, mask.to(torch.int32))


HIST_BUCKETS = 64
HIST_MIN_MS = 0.25
HIST_PER_OCTAVE = 4.0


def _xla_bucket(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2(x) * 4)`` for float32 ``x >= 1`` as the reference's
    jitted program rounds it: ``log2(x)`` is XLA's ``log(x)`` times the
    folded float32 constant ``4 / ln 2`` (``floatops``, float64 inside)."""
    scale = floatops.f32(floatops.recip(floatops.f32(np.log(2.0))) * HIST_PER_OCTAVE)
    return torch.floor(floatops.log(x) * scale)


def _bucket_edges() -> list:
    """The smallest float32 latency (ms) of each histogram bucket 1 .. 63 as
    the reference assigns buckets: a bisection over float32 bit patterns,
    run on the host once. (Plain ``log2`` puts the latencies of exactly
    4096 and 16384 ticks one bucket higher.)"""
    k = torch.arange(1, HIST_BUCKETS, dtype=torch.float32)
    lo = torch.ones_like(k).view(torch.int32)  # bucket 0
    hi = torch.full_like(k, 2.0 ** (HIST_BUCKETS / HIST_PER_OCTAVE + 1)).view(torch.int32)
    while bool((hi - lo > 1).any()):
        mid = lo + (hi - lo) // 2
        ok = _xla_bucket(mid.view(torch.float32)) >= k
        hi, lo = torch.where(ok, mid, hi), torch.where(ok, lo, mid)
    return (hi.view(torch.float32) * HIST_MIN_MS).tolist()  # x = lat / 0.25, exact


BUCKET_EDGES_MS = _bucket_edges()


@functools.lru_cache(maxsize=None)
def _edges_on(device: torch.device) -> torch.Tensor:
    # built from scalars on the device: no host-to-device copy, no sync
    return torch.stack([torch.full((), e, dtype=torch.float32, device=device)
                        for e in BUCKET_EDGES_MS])


def latency_bucket(lat_ms: torch.Tensor) -> torch.Tensor:
    """The log-spaced histogram bucket of each float32 latency, equal to the
    reference's jitted ``latency_bucket``: the number of bucket edges
    (:data:`BUCKET_EDGES_MS`) at or below it. No float64 reaches the tick."""
    return torch.bucketize(lat_ms, _edges_on(lat_ms.device), right=True).to(torch.int32)


def bucket_upper_ms(i: np.ndarray) -> np.ndarray:
    return HIST_MIN_MS * 2.0 ** ((i + 1) / HIST_PER_OCTAVE)


def bucket_lower_ms(i: np.ndarray) -> np.ndarray:
    return HIST_MIN_MS * 2.0 ** (np.asarray(i) / HIST_PER_OCTAVE)


def hist_quantile(hist: np.ndarray, q: float) -> float:
    """Quantile of a log-bucketed latency histogram (host-side, np).

    Linearly interpolates within the containing bucket instead of snapping to
    its upper edge. Returns 0.0 for an empty histogram.
    """
    hist = np.asarray(hist, np.float64)
    total = hist.sum()
    if total <= 0:
        return 0.0
    cum = np.cumsum(hist)
    target = q * total
    i = int(np.searchsorted(cum, target))
    i = min(i, len(hist) - 1)
    in_bucket = hist[i]
    before = cum[i] - in_bucket
    # bucket 0's nominal lower edge is HIST_MIN_MS, but sub-minimum latencies
    # clip into it, so its interpolation floor is 0
    lo = 0.0 if i == 0 else float(bucket_lower_ms(i))
    hi = float(bucket_upper_ms(np.asarray(i)))
    frac = (target - before) / in_bucket if in_bucket > 0 else 1.0
    return lo + float(np.clip(frac, 0.0, 1.0)) * (hi - lo)


class SimState(NamedTuple):
    t: torch.Tensor  # current tick (0-d i32)

    # ---- probe / DA table (P,) ------------------------------------------
    st: torch.Tensor  # state machine code
    zone: torch.Tensor  # current zone
    node: torch.Tensor  # current / target node
    contig: torch.Tensor  # L-task (strictly contiguous demand)
    squat: torch.Tensor  # squatter (never completes payload pull)
    tier: torch.Tensor  # workload class: 0 prod / 1 batch / 2 best-effort (i32)
    migrating: torch.Tensor  # DA in secondary-reactivation epoch
    mass: torch.Tensor  # atoms demanded (i32)
    ev: torch.Tensor  # E_v,init static routing weight (f32)
    patience: torch.Tensor  # remaining E_patience (f32)
    deposit: torch.Tensor  # frozen deposit while pending (f32)
    timer: torch.Tensor  # generic countdown: hop / pull / quiet (i32 ticks)
    pull_dur: torch.Tensor  # pre-sampled payload pull duration (i32 ticks)
    pull_deadline: torch.Tensor  # reservation expiry tick (i32)
    surv_deadline: torch.Tensor  # shared survival TTL expiry tick (i32)
    susp_tick: torch.Tensor  # tick at which suspension began
    arrival: torch.Tensor  # arrival tick
    start: torch.Tensor  # execution start tick (-1 before)
    service: torch.Tensor  # remaining service ticks while RUNNING
    regen: torch.Tensor  # regeneration instances used
    mem: torch.Tensor  # true physical memory usage while resident (f32)
    alloc: torch.Tensor  # (P, W) held atom words at alloc_node
    alloc_node: torch.Tensor  # node where atoms are held (-1 none)
    alloc2: torch.Tensor  # (P, W) destination reservation during migration
    node2: torch.Tensor  # destination node during migration (-1 none)

    # ---- node table (N,) --------------------------------------------------
    free: torch.Tensor  # (N, W) free-atom bitmap words
    zone_id: torch.Tensor
    rep_S: torch.Tensor  # reported (stale) slack
    rep_H: torch.Tensor  # reported (stale) heat
    rep_run: torch.Tensor  # reported (stale) max contiguous run
    rep_t: torch.Tensor  # tick of last successful report
    dS: torch.Tensor  # EMA slack derivative (atoms / ms)
    dH: torch.Tensor
    next_rep: torch.Tensor  # next report tick
    amb: torch.Tensor  # ambient memory perturbation (AR(1), fraction of cap)
    rigid_mem: torch.Tensor  # rigid-topology resident memory (fraction of cap)
    node_up: torch.Tensor  # (N,) bool: node currently serving
    down_until: torch.Tensor  # (N,) i32 recovery tick while down
    free0: torch.Tensor  # (N, W) painted free bitmap at init

    # ---- zone table (Z,) ---------------------------------------------------
    zstart: torch.Tensor
    zcount: torch.Tensor
    zS: torch.Tensor  # TEG aggregate: mean reported slack
    zH: torch.Tensor  # TEG aggregate: total reported heat
    zmember: torch.Tensor  # (Z, M) node index per zone slot (0 where invalid)
    zmask: torch.Tensor  # (Z, M) validity (f32: 1.0 member, 0.0 padding)

    metrics: Metrics


# bitmap word fields: uint32 in the JAX package, int32 bit patterns here
WORD_FIELDS = ("alloc", "alloc2", "free", "free0")


def build_zones(cfg: LaminarConfig, rng: np.random.Generator):
    """Heterogeneous contiguous zones (target size +/- jitter)."""
    sizes = []
    left = cfg.num_nodes
    while left > 0:
        j = 1.0 + rng.uniform(-cfg.zone_size_jitter, cfg.zone_size_jitter)
        s = int(max(8, min(left, round(cfg.zone_size * j))))
        if left - s < 8:
            s = left
        sizes.append(s)
        left -= s
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    counts = np.asarray(sizes, np.int32)
    zone_id = np.repeat(np.arange(len(sizes), dtype=np.int32), counts)
    return starts, counts, zone_id


def densify_zones(starts: np.ndarray, counts: np.ndarray):
    """(Z, M) member-index matrix + validity mask for heterogeneous zones."""
    M = int(counts.max())
    lane = np.arange(M, dtype=np.int32)[None, :]
    mask = lane < counts[:, None]
    member = np.where(mask, starts[:, None] + lane, 0).astype(np.int32)
    return member, mask.astype(np.float32)


# ---------------------------------------------------------------------------
# zone-blocked layout: flat node-major (N, ...) <-> padded (Z, M, ...)
# ---------------------------------------------------------------------------
# The zone-sharded engine (repro_torch.parallel.engine_mesh) splits the
# node-plane work along the zone axis. Zones are heterogeneous, so the
# blocked layout is PADDED: row z holds zone z's nodes in slots
# [0, zcount[z]) and inert fill elsewhere.


def pack_zoned(
    x: torch.Tensor, zmember: torch.Tensor, zmask: torch.Tensor, fill=0
) -> torch.Tensor:
    """Flat node-major ``(N, ...)`` -> padded zone-blocked ``(Z, M, ...)``.

    Valid slots gather their node's row; padding slots are set to ``fill``."""
    v = x[zmember.long()]  # (Z, M, ...)
    mask = (zmask > 0).reshape(zmask.shape + (1,) * (v.dim() - zmask.dim()))
    return torch.where(mask, v, torch.tensor(fill, dtype=v.dtype, device=v.device))


def unpack_zoned(
    xb: torch.Tensor, zmember: torch.Tensor, zmask: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """Padded zone-blocked ``(Z, M, ...)`` -> flat node-major ``(N, ...)``.

    Every node occupies exactly one valid slot, so the scatter writes each
    flat row exactly once. Padding slots point at node 0 in ``zmember``; they
    go to a spare row that is cut off, so they never clobber node 0. ``xb``
    may carry more zone rows than ``zmember`` (padding to a multiple of the
    device count); those rows are ignored."""
    Z, M = zmember.shape
    xb = xb[:Z]
    tgt = torch.where(zmask > 0, zmember, num_nodes).reshape(-1).long()
    flat = xb.reshape((Z * M,) + tuple(xb.shape[2:]))
    out = torch.zeros((num_nodes + 1,) + tuple(xb.shape[2:]), dtype=xb.dtype, device=xb.device)
    out.index_copy_(0, tgt, flat)
    return out[:num_nodes]


def paint_rigid(cfg: LaminarConfig, rng: np.random.Generator):
    """Pre-occupy node bitmaps with rigid-topology chunks (post-landing ecology)."""
    A = cfg.atoms_per_node
    n = cfg.num_nodes
    bits = np.ones((n, A), dtype=bool)  # True = free
    frac = rng.uniform(cfg.rigid_frac_lo, cfg.rigid_frac_hi, size=n)
    occupied = np.zeros(n, np.int32)
    target = (frac * A).astype(np.int32)
    for _ in range(cfg.rigid_chunks):
        remaining = np.maximum(target - occupied, 0)
        chunk = np.ceil(remaining / max(1, cfg.rigid_chunks)).astype(np.int32)
        chunk = np.minimum(chunk, remaining)
        start = rng.integers(0, A, size=n)
        for i in range(n):  # init-time only; O(N * A) host work
            c = int(chunk[i])
            if c == 0:
                continue
            s = int(start[i])
            e = min(s + c, A)
            taken = int(bits[i, s:e].sum())
            bits[i, s:e] = False
            occupied[i] += taken
    rigid_atoms = A - bits.sum(axis=1)
    return bits, rigid_atoms.astype(np.float32)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """(N, atoms) bool -> (N, W) int32 bit patterns (host-side, LSB-first)."""
    n, atoms = bits.shape
    n_words = (atoms + 31) // 32
    padded = np.zeros((n, n_words * 32), bool)
    padded[:, :atoms] = bits
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    words = (padded.reshape(n, n_words, 32) * weights).sum(-1, dtype=np.uint32)
    return words.view(np.int32)


def init_numpy(cfg: LaminarConfig, seed: int = 0) -> Dict[str, object]:
    """The initial state as numpy arrays (JAX dtypes; words as uint32).

    Rebuilds the geometry with the same ``default_rng(seed)`` calls, in the
    same order, as ``repro.core.state.init_state``.
    """
    rng = np.random.default_rng(seed)
    P = cfg.probe_capacity
    N = cfg.num_nodes
    W = max(1, (cfg.atoms_per_node + 31) // 32)

    zstart, zcount, zone_id = build_zones(cfg, rng)
    zmember, zmask = densify_zones(zstart, zcount)
    Z = len(zcount)
    bits, rigid_atoms = paint_rigid(cfg, rng)
    free_words = pack_bits_np(bits).view(np.uint32).reshape(N, W)

    free0 = bits.sum(axis=1).astype(np.float32)
    run0 = np.zeros(N, np.float32)
    for i in range(N):
        r = best = 0
        for b in bits[i]:
            r = r + 1 if b else 0
            best = max(best, r)
        run0[i] = best

    zS0 = np.zeros(Z, np.float32)
    for z in range(Z):
        sl = slice(zstart[z], zstart[z] + zcount[z])
        zS0[z] = free0[sl].mean()

    rep_interval = cfg.ticks(cfg.report_interval_ms + cfg.extra_sync_delay_ms)
    first_rep = rng.integers(0, rep_interval, size=N)

    zi = lambda n: np.zeros(n, np.int32)
    zf = lambda n: np.zeros(n, np.float32)
    out: Dict[str, object] = dict(
        t=np.zeros((), np.int32),
        st=zi(P),
        zone=zi(P),
        node=np.full(P, -1, np.int32),
        contig=np.zeros(P, bool),
        squat=np.zeros(P, bool),
        tier=zi(P),
        migrating=np.zeros(P, bool),
        mass=zi(P),
        ev=zf(P),
        patience=zf(P),
        deposit=zf(P),
        timer=zi(P),
        pull_dur=zi(P),
        pull_deadline=zi(P),
        surv_deadline=zi(P),
        susp_tick=zi(P),
        arrival=zi(P),
        start=np.full(P, -1, np.int32),
        service=zi(P),
        regen=zi(P),
        mem=zf(P),
        alloc=np.zeros((P, W), np.uint32),
        alloc_node=np.full(P, -1, np.int32),
        alloc2=np.zeros((P, W), np.uint32),
        node2=np.full(P, -1, np.int32),
        free=free_words,
        zone_id=zone_id.astype(np.int32),
        rep_S=free0,
        rep_H=zf(N),
        rep_run=run0,
        rep_t=zi(N),
        dS=zf(N),
        dH=zf(N),
        next_rep=first_rep.astype(np.int32),
        amb=zf(N),
        rigid_mem=(rigid_atoms / cfg.atoms_per_node).astype(np.float32),
        node_up=np.ones(N, bool),
        down_until=zi(N),
        free0=free_words.copy(),
        zstart=zstart.astype(np.int32),
        zcount=zcount.astype(np.int32),
        zS=zS0,
        zH=zf(Z),
        zmember=zmember.astype(np.int32),
        zmask=zmask.astype(np.float32),
    )
    out["metrics"] = {
        f: v.numpy() for f, v in Metrics.zeros("cpu", HIST_BUCKETS)._asdict().items()
    }
    return out


def state_from_numpy(d: Dict[str, object], device) -> SimState:
    """Carry a state given as numpy arrays (JAX field names and dtypes,
    uint32 words) onto ``device``. Fields the port does not hold (the PRNG
    keys) are ignored."""

    def conv(name, x):
        x = np.asarray(x)
        if name in WORD_FIELDS:
            x = np.ascontiguousarray(x).view(np.int32)
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    fields = {f: conv(f, d[f]) for f in SimState._fields if f != "metrics"}
    m = d["metrics"]
    metrics = Metrics(**{f: conv(f, m[f]) for f in Metrics._fields})
    return SimState(**fields, metrics=metrics)


def state_to_numpy(s: SimState) -> Dict[str, object]:
    """The state as numpy arrays with the JAX package's dtypes (uint32 words)."""

    def conv(name, x):
        a = x.detach().cpu().numpy()
        return a.view(np.uint32) if name in WORD_FIELDS else a

    out: Dict[str, object] = {
        f: conv(f, getattr(s, f)) for f in SimState._fields if f != "metrics"
    }
    out["metrics"] = {f: conv(f, getattr(s.metrics, f)) for f in Metrics._fields}
    return out


def init_state(cfg: LaminarConfig, seed: int, device) -> SimState:
    """Initial state on ``device``; every field equals the JAX package's
    ``init_state(cfg, seed)`` (the PRNG keys aside)."""
    return state_from_numpy(init_numpy(cfg, seed), device)
