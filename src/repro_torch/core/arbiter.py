"""Node Arbitrator (§III-G, §IV-D), a port of ``repro.core.arbiter``.

Admission closes at a single node through a pre-admission memory check
(throttle), winner selection among queued DAs by E_v,init, feasibility against
the *true* residual bitmap, a TTL-bounded reservation with a frozen patience
deposit, payload pull within the valid window, and timing-wheel expiry.
Arbitration is computed *per node* (one winner per node per round), so all
bitmap work is (N, A)-shaped, never (P, A)-shaped.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitmap, hotpath
from repro_torch.core.config import LaminarConfig
from repro_torch.core.state import (
    ADDRESSING,
    EMPTY,
    LOST_WAIT,
    QUEUED,
    RESERVED,
    RUNNING,
    SimState,
    count,
    latency_bucket,
    scatter_sum,
    tier_counts,
)

INF_TICK = 1 << 30


def _free_atoms_at(
    free: torch.Tensor, alloc: torch.Tensor, node: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Return freed node bitmap words: free |= alloc for each masked probe.

    Held allocations are disjoint, so an int32 add of their bit patterns is
    their OR. Rows that are unmasked or hold no node add nothing.
    """
    return free | scatter_sum(free.shape[0], node, mask & (node >= 0), alloc)


def elect(st: torch.Tensor, node: torch.Tensor, ev: torch.Tensor, throttled: torch.Tensor):
    """One round's winner per node: the queued probe (``st == QUEUED``, its
    node not throttled) of the highest E_v, then the highest slot among
    those tied (a two-stage scatter-max), none where that E_v is not finite.

    Returns (winner (P,) bool, wslot (N,) int32 with -1 for no winner). The
    plain version of ``bitmap_fit_rounds`` runs it too."""
    P, N = st.shape[0], throttled.shape[0]
    dev = st.device
    node_c = torch.clamp(node, 0, N - 1)
    node_x = torch.clamp(node, 0, N).long()
    queued = (st == QUEUED) & ~throttled[node_c]
    # E_v ties must still elect exactly ONE probe per node
    slot = torch.arange(P, dtype=torch.int32, device=dev)
    score = torch.where(queued, ev, -torch.inf)
    tgt = torch.where(queued, node, N).long()
    best = torch.full((N + 1,), -torch.inf, dtype=torch.float32, device=dev)
    best.scatter_reduce_(0, tgt, score, "amax")
    top_ev = queued & (score == best[node_x]) & torch.isfinite(score)
    # among equal-E_v toppers, take the max slot index (unique per node)
    wslot = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    wslot.scatter_reduce_(
        0, torch.where(top_ev, node, N).long(), torch.where(top_ev, slot, -1), "amax"
    )
    winner = top_ev & (slot == wslot[node_x])
    return winner, wslot[:N]


def alloc_round(
    bits: torch.Tensor,
    mass: torch.Tensor,
    contig: torch.Tensor,
    fit: torch.Tensor,
    has_w: torch.Tensor,
    policy: str,
):
    """One round's allocation per node for its winner's demand (``mass``,
    ``contig``) on the (N, A) free bit plane. ``fit`` is the fit test's
    0/1 on the node's words; a node is feasible where it has a winner, the
    test passes and the policy finds atoms. Returns (taken words (N, W),
    feas (N,), the bit plane without the taken atoms). The plain version
    of ``bitmap_fit_rounds`` runs it too."""
    alloc_bits, feas = bitmap.alloc_for_class(bits, mass, contig, policy=policy)
    feas = feas & (fit != 0) & has_w
    taken = alloc_bits & feas[:, None]
    return bitmap.pack_bits(taken), feas, bits & ~taken


def arbitrate(
    cfg: LaminarConfig,
    s: SimState,
    throttled: torch.Tensor,
    bits: torch.Tensor,
):
    """One admission round per node: highest-E_v queued DA, bitmap-feasible.

    Takes and returns the (N, A) free bit-plane so multiple rounds per tick
    avoid re-unpacking the word bitmap. Returns (state, bits').

    Both ticks run all their rounds at once (:func:`arbitrate_rounds`, and
    ``MeshPlane.arb_rounds`` on the sharded tick), so this one-round step,
    with the one-round ``bitmap_fit``, runs in no tick: it is the reference
    the tests hold ``arbitrate_rounds`` to, round by round.
    """
    P = s.st.shape[0]
    N = cfg.num_nodes
    node_c = torch.clamp(s.node, 0, N - 1)
    # winner by E_v with an exact integer tiebreak (two-stage scatter-max)
    winner, wslot = elect(s.st, s.node, s.ev, throttled)
    has_w = wslot >= 0
    ws = torch.clamp(wslot, 0, P - 1)

    # feasibility against the TRUE residual bitmap, computed once per node
    # for its winner's demand: the bitmap_fit hot-path op, on the words that
    # are kept in step with the ``bits`` plane across rounds. The AND in
    # alloc_round is a guard: a kernel fault could only reject admissions.
    w_mass = s.mass[ws]
    w_contig = s.contig[ws]
    fit = hotpath.bitmap_fit(s.free, w_mass, w_contig)
    alloc_words_n, feas_n, bits = alloc_round(
        bits, w_mass, w_contig, fit, has_w, cfg.alloc_policy
    )
    admit = winner & feas_n[node_c]
    s = _admissions(
        cfg, s, winner, admit, alloc_words_n[node_c], s.free & ~alloc_words_n,
        count(throttled),
    )
    return s, bits


def arbitrate_rounds(cfg: LaminarConfig, s: SimState, throttled: torch.Tensor) -> SimState:
    """All ``cfg.arb_rounds`` admission rounds of the flat tick in one call:
    the same state as that many :func:`arbitrate` calls.

    A round's winner leaves the queue whether it is admitted or not, and
    nothing the election reads changes between rounds, so one
    ``bitmap_fit_rounds`` (one kernel launch on the card) computes every
    round's winners, feasibility and allocations, and each probe's
    transition is applied once, for the round it won.
    """
    N = cfg.num_nodes
    R = cfg.arb_rounds
    node_c = torch.clamp(s.node, 0, N - 1)
    _, _, alloc, won, admit = hotpath.bitmap_fit_rounds(cfg, s, throttled)
    # each probe's taken words: its node's row of the round it won
    flat = alloc.reshape(R * N, -1)
    probe_alloc = flat[torch.clamp(won, min=0) * N + node_c]
    # the rounds take disjoint atoms, so the int32 sum of their words is their OR
    taken = torch.sum(alloc, dim=0, dtype=torch.int32)
    return _admissions(
        cfg, s, won >= 0, admit, probe_alloc, s.free & ~taken, R * count(throttled)
    )


def _admissions(
    cfg: LaminarConfig,
    s: SimState,
    winner: torch.Tensor,
    admit: torch.Tensor,
    probe_alloc: torch.Tensor,
    free: torch.Tensor,
    throttled_rounds: torch.Tensor,
) -> SimState:
    """The state transitions of elected probes: ``winner`` (P,) elected,
    ``admit`` (P,) admitted, ``probe_alloc`` (P, W) the words an admitted
    probe took, ``free`` the node words after the allocations."""
    reject = winner & ~admit
    st = s.st
    migrating = s.migrating

    # ordinary admission -> two-phase reservation (atoms held logically)
    prim = admit & ~migrating
    if cfg.two_phase:
        dep = torch.clamp(torch.clamp(s.patience, min=0.0), max=cfg.deposit)
    else:
        dep = torch.zeros_like(s.patience)
    patience = torch.where(prim, s.patience - dep, s.patience)
    deposit = torch.where(prim, dep, s.deposit)

    st = torch.where(prim, RESERVED, st)
    alloc = torch.where(prim[:, None], probe_alloc, s.alloc)
    alloc_node = torch.where(prim, s.node, s.alloc_node)
    if cfg.workload.squatter_ratio > 0:
        pull = torch.where(s.squat, INF_TICK, s.pull_dur)
    else:
        pull = s.pull_dur
    timer = torch.where(prim, pull, s.timer)
    pull_deadline = torch.where(
        prim,
        (s.t + cfg.ticks(cfg.pull_ttl_ms)) if cfg.two_phase else INF_TICK,
        s.pull_deadline,
    )

    # migration landing -> destination reservation in alloc2 (state pull)
    alloc2, node2 = s.alloc2, s.node2
    if cfg.airlock and cfg.memory.enabled:
        mig = admit & migrating
        st = torch.where(mig, RESERVED, st)
        alloc2 = torch.where(mig[:, None], probe_alloc, s.alloc2)
        node2 = torch.where(mig, s.node, s.node2)
        state_pull = (
            torch.ceil(
                s.mass.to(torch.float32) * cfg.state_pull_ms_per_atom / cfg.dt_ms
            ).to(torch.int32)
            + 1
        )
        timer = torch.where(mig, state_pull, timer)
        pull_deadline = torch.where(
            mig, s.t + cfg.ticks(cfg.pull_ttl_ms), pull_deadline
        )

    # infeasible winner: pay a re-address, return to kinetic addressing
    st = torch.where(reject, ADDRESSING, st)
    patience = torch.where(reject, patience - cfg.eval_cost, patience)

    m = s.metrics
    m = m._replace(
        op_arb=m.op_arb + count(winner),
        infeasible_winner=m.infeasible_winner + count(reject),
        throttled_rounds=m.throttled_rounds + throttled_rounds,
    )
    return s._replace(
        st=st,
        free=free,
        alloc=alloc,
        alloc_node=alloc_node,
        alloc2=alloc2,
        node2=node2,
        timer=timer,
        patience=patience,
        deposit=deposit,
        pull_deadline=pull_deadline,
        metrics=m,
    )


def pending_stage(cfg: LaminarConfig, s: SimState) -> SimState:
    """Payload / state pull progress, execution start, reservation expiry."""
    airlock_on = cfg.airlock and cfg.memory.enabled
    reserved = s.st == RESERVED
    timer = torch.where(reserved, s.timer - 1, s.timer)

    done = reserved & (timer <= 0) & (s.t <= s.pull_deadline)
    expired = reserved & (timer > 0) & (s.t >= s.pull_deadline)

    # ---- primary landing: execution start ------------------------------
    start_now = done & ~s.migrating
    st = torch.where(start_now, RUNNING, s.st)
    start = torch.where(start_now, s.t, s.start)
    patience = torch.where(start_now, s.patience + s.deposit, s.patience)  # unfreeze
    deposit = torch.where(start_now, 0.0, s.deposit)

    free, alloc, alloc_node = s.free, s.alloc, s.alloc_node
    alloc2, node2 = s.alloc2, s.node2
    migrating = s.migrating
    m = s.metrics

    # ---- migration landing: new execution epoch recognized --------------
    if airlock_on:
        mig_ok = done & s.migrating & (s.t <= s.surv_deadline)
        mig_late = done & s.migrating & (s.t > s.surv_deadline)
        mig_fail = (expired & s.migrating) | mig_late
        # source freed on success; both sides freed on bounded reclamation
        free = _free_atoms_at(free, s.alloc, s.alloc_node, mig_ok | mig_fail)
        free = _free_atoms_at(free, s.alloc2, s.node2, mig_fail)
        alloc = torch.where(mig_ok[:, None], s.alloc2, alloc)
        alloc = torch.where(mig_fail[:, None], 0, alloc)
        alloc_node = torch.where(mig_ok, s.node2, alloc_node)
        alloc_node = torch.where(mig_fail, -1, alloc_node)
        alloc2 = torch.where((mig_ok | mig_fail)[:, None], 0, alloc2)
        node2 = torch.where(mig_ok | mig_fail, -1, node2)
        st = torch.where(mig_ok, RUNNING, st)
        st = torch.where(mig_fail, EMPTY, st)
        migrating = torch.where(mig_ok | mig_fail, False, migrating)
        m = m._replace(
            migrated=m.migrated + count(mig_ok),
            reclaimed=m.reclaimed + count(mig_fail),
            reclaimed_tier=m.reclaimed_tier + tier_counts(s.tier, mig_fail),
        )

    # ---- primary reservation expiry --------------------------------------
    # restore bitmap, forfeit deposit, re-address (or dissipate)
    prim_exp = expired & ~s.migrating
    squat_exp = prim_exp & s.squat
    retry = prim_exp & ~s.squat
    free = _free_atoms_at(free, s.alloc, s.alloc_node, prim_exp)
    alloc = torch.where(prim_exp[:, None], 0, alloc)
    alloc_node = torch.where(prim_exp, -1, alloc_node)
    deposit = torch.where(prim_exp, 0.0, deposit)  # forfeited
    st = torch.where(retry & (patience >= cfg.fastfail_floor), ADDRESSING, st)
    st = torch.where(retry & (patience < cfg.fastfail_floor), EMPTY, st)
    st = torch.where(squat_exp, EMPTY, st)

    # ---- metrics ----------------------------------------------------------
    lat_ms = (s.t - s.arrival).to(torch.float32) * cfg.dt_ms
    bucket = latency_bucket(lat_ms)
    started = start_now.to(torch.int32)
    T, B = m.lat_hist_tier.shape
    hist = m.lat_hist + scatter_sum(B, bucket, start_now, started)
    hist_tier = m.lat_hist_tier + scatter_sum(
        T * B, s.tier * B + bucket, start_now, started
    ).reshape(T, B)
    m = m._replace(
        started=m.started + count(start_now),
        started_f=m.started_f + count(start_now & ~s.contig),
        started_l=m.started_l + count(start_now & s.contig),
        started_tier=m.started_tier + tier_counts(s.tier, start_now),
        reserve_expired=m.reserve_expired + count(prim_exp),
        squat_expired=m.squat_expired + count(squat_exp),
        lat_hist=hist,
        lat_hist_tier=hist_tier,
    )
    return s._replace(
        st=st,
        timer=timer,
        start=start,
        patience=patience,
        deposit=deposit,
        free=free,
        alloc=alloc,
        alloc_node=alloc_node,
        alloc2=alloc2,
        node2=node2,
        migrating=migrating,
        metrics=m,
    )


def completions(cfg: LaminarConfig, s: SimState) -> SimState:
    """Service progress; normal completion retires the resident DA with it."""
    running = s.st == RUNNING
    service = torch.where(running, s.service - 1, s.service)
    done = running & (service <= 0)

    free = _free_atoms_at(s.free, s.alloc, s.alloc_node, done)
    m = s.metrics
    m = m._replace(
        completed=m.completed + count(done),
        completed_f=m.completed_f + count(done & ~s.contig),
        completed_l=m.completed_l + count(done & s.contig),
        completed_tier=m.completed_tier + tier_counts(s.tier, done),
    )
    return s._replace(
        st=torch.where(done, EMPTY, s.st),
        service=service,
        free=free,
        alloc=torch.where(done[:, None], 0, s.alloc),
        alloc_node=torch.where(done, -1, s.alloc_node),
        mem=torch.where(done, 0.0, s.mem),
        metrics=m,
    )


def timeouts(cfg: LaminarConfig, s: SimState) -> SimState:
    """Absolute arrival->start timeout for control-phase probes (not running,
    not suspended/migrating: those are governed by T_susp / T_surv)."""
    control = (((s.st > EMPTY) & (s.st < RUNNING)) | (s.st == LOST_WAIT)) & ~s.migrating
    late = control & ((s.t - s.arrival) > cfg.ticks(cfg.task_timeout_ms))
    # RESERVED probes may hold atoms: restore
    free = _free_atoms_at(s.free, s.alloc, s.alloc_node, late)
    m = s.metrics
    m = m._replace(timeout=m.timeout + count(late))
    return s._replace(
        st=torch.where(late, EMPTY, s.st),
        free=free,
        alloc=torch.where(late[:, None], 0, s.alloc),
        alloc_node=torch.where(late, -1, s.alloc_node),
        metrics=m,
    )
