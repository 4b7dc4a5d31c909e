"""Launch plan of ``csrc/survival_scan.cu``: one launch of one cluster.

The whole survival decision is one cluster of ``CLUSTER`` CTAs of
``THREADS`` threads (grid == cluster). Sixteen is the H100's non-portable
maximum, so the plan sets the non-portable attribute: the widest cluster
streams the columns through the most SMs, keeps a thread's slots within
``MAX_STEPS`` register-held steps up to P = 131 072, and halves each CTA's
node range against eight. ``chip_smoke.py`` phase 2b asks the card
(``cudaOccupancyMaxActiveClusters``) that the cluster can be resident.

CTA ``c`` holds slots ``[c * S, (c + 1) * S)``, ``S = 1024 * steps`` and
nodes ``[c * nb, (c + 1) * nb)``, ``nb = ceil(N / CLUSTER)``; its dynamic
shared memory (:func:`smem_bytes`, the source's ``layout``) holds 12 B a
node and the count tables. The global scratch has two carve-outs: ``ent``,
the 16-byte (node, value, victim key) entries of the slot-ordered fold
(four int32 words a slot), and ``info``, one mask word a node (its victim's
slot and whether its pressure is under ``safe``). Shapes the cluster cannot
hold are refused with the limit in the message: P past 2^17 (the victim
key's slot field), N past :func:`max_nodes` (227 KiB of shared memory a
CTA).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.launch_plan import (
    Carve,
    Launch,
    LaunchPlan,
    Operand,
    Output,
    batched,
    cdiv,
)

KERNELS = ("survival_cluster_kernel",)  # the order of survival_scan_attrs
THREADS = 1024  # kThreads of csrc/survival_scan.cu
WARPS = THREADS // 32
CLUSTER = 16  # CTAs of the one cluster
PORTABLE_CLUSTER = 8  # the largest cluster every Hopper part schedules
MAX_STEPS = 8  # kMaxSteps: slots a thread holds
SLOT_BITS = 17  # kSlotBits of the victim key (tier 15 | score 32 | slot 17)
MAX_SLOTS = min(1 << SLOT_BITS, CLUSTER * THREADS * MAX_STEPS)
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may opt in to
COLUMNS = ("st", "alloc_node", "mem", "ev", "tier", "migrating", "susp_tick", "surv_deadline")


def smem_bytes(N: int) -> int:
    """Dynamic shared memory of one CTA: ``survival_scan_smem_bytes``."""
    nb, bins = cdiv(N, CLUSTER), CLUSTER * WARPS
    return (12 * nb + 4 * WARPS * bins + 4 * CLUSTER * bins + 4 * bins + 8 * WARPS
            + 12 * THREADS + 4 * WARPS)


def max_nodes() -> int:
    """The largest N whose node range fits a CTA's shared memory."""
    return (SMEM_LIMIT - smem_bytes(0)) // 12 * CLUSTER


def steps(P: int) -> int:
    """Slots a thread holds: one step of 32 slots a warp at a time."""
    return cdiv(P, CLUSTER * THREADS)


def scratch_words(P: int, N: int) -> int:
    """Words of int32 scratch: ``survival_scan_scratch_words`` of the source."""
    return 4 * P + N


def scratch_stride(P: int, N: int) -> int:
    """Words between two seeds' scratch in a batched launch:
    ``survival_scan_scratch_stride`` of the source (a seed's words, rounded
    up to whole 16-byte entries so that each seed's ``ent`` is aligned)."""
    return 4 * P + cdiv(N, 4) * 4


def scratch_layout(P: int, N: int):
    return (Carve("ent", 0, 4 * P), Carve("info", 4 * P, N))


@functools.lru_cache(maxsize=None)
def plan(P: int, N: int, airlock: bool, seeds: int = 0) -> LaunchPlan:
    """The one launch at (P, N). Airlock changes what the kernel computes,
    not its geometry. ``seeds``: 0 for one seed's call, else that of a call
    with a seed axis of that many seeds: cluster ``b`` on seed
    ``b``'s columns, outputs and scratch (no cluster barrier spans two
    seeds); clusters past what the card holds at once
    (``cudaOccupancyMaxActiveClusters``) run in later waves."""
    if seeds:
        return batched(plan(P, N, airlock), seeds, scratch_stride(P, N))
    if N < 1:
        raise ValueError(f"survival_scan: N = {N}: the cluster needs at least one node")
    if P > MAX_SLOTS:
        raise ValueError(
            f"survival_scan: P = {P} slots > {MAX_SLOTS}, the most one cluster takes "
            f"(victim key slot field {SLOT_BITS} bits; {CLUSTER} x {THREADS} threads x "
            f"{MAX_STEPS} slots)")
    smem = smem_bytes(N)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"survival_scan: N = {N} nodes need {smem} B of shared memory a CTA > "
            f"{SMEM_LIMIT} B; the largest N a cluster of {CLUSTER} holds is {max_nodes()}")
    S, nb = steps(P) * THREADS, cdiv(N, CLUSTER)
    ops = tuple(Operand(c, P, S) for c in COLUMNS)
    ops += (Operand("base", N, nb), Operand("pressure", N, nb, write=True))
    ops += tuple(Operand(m, P, S, write=True) for m in ("victim", "resume", "react", "expire"))
    return LaunchPlan(
        entry="survival_scan",
        source="survival_scan",
        launches=(Launch("survival_cluster_kernel", CLUSTER, THREADS, ops, dynamic_smem=smem,
                         cluster=CLUSTER, cluster_nonportable=CLUSTER > PORTABLE_CLUSTER),),
        outputs=(Output("pressure", (N,), torch.float32),
                 *(Output(m, (P,), torch.bool) for m in ("victim", "resume", "react", "expire"))),
        scratch_words=scratch_words(P, N),
        scratch=scratch_layout(P, N),
    )


def pack(p: LaunchPlan):
    """``p`` as the launcher takes it: (grid, block, cluster, non-portable,
    dynamic shared memory, steps)."""
    (L,) = p.launches
    return (L.grid, L.block, L.cluster, int(L.cluster_nonportable), L.dynamic_smem,
            L.operands[0].rows_per_block // L.block)


@functools.lru_cache(maxsize=None)
def launch_args(P: int, N: int, airlock: bool):
    """:func:`pack` of :func:`plan`, cached by shape (a plan hashes slowly)."""
    return pack(plan(P, N, airlock))


def for_call(st, alloc_node, mem, ev, tier, migrating, susp_tick, surv_deadline, base, t,
             *, airlock: bool, **_) -> LaunchPlan:
    """The plan of ``survival_scan``, batched when the columns have a
    leading seed axis."""
    return plan(st.shape[-1], base.shape[-1], bool(airlock), *st.shape[:-1])
