"""Launch plans of ``csrc/utility_topk.cu``: a thread a probe row.

``utility_topk`` launches ``utility_topk_kernel`` over the ``(P, K)`` tiles;
``utility_topk_address`` launches ``utility_topk_address_kernel`` over the
probe columns, a warp 32 slots, and given a leading seed axis the same
kernel over B seeds (grid ``(ceil(P / THREADS), B)``). The address
kernel reads the zone and node vectors at data-dependent rows (not listed)
and sums its three counts in an accumulator of its own
(``ACC_POOL_WORDS``), which the last CTA of a seed moves into the
``counts`` output: no memset precedes the launch.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.launch_plan import Launch, LaunchPlan, Operand, Output, batched, cdiv

# the order of utility_topk_attrs
KERNELS = ("utility_topk_kernel", "utility_topk_address_kernel")
THREADS = 256  # kThreads of csrc/utility_topk.cu
ACC_POOL_WORDS = 1 << 18  # kAccPoolWords: the count accumulators, 4 words a seed
# utility_topk_address's inputs, in the order of its arguments and of the
# launcher's pointers (AddressArgs of csrc/utility_topk.cu): name, dtype and
# shape by P slots, K candidates, Z zones and N nodes ("" a scalar)
ADDRESS_INPUTS = (
    ("st", torch.int32, "P"), ("node", torch.int32, "P"), ("zone", torch.int32, "P"),
    ("timer", torch.int32, "P"), ("patience", torch.float32, "P"),
    ("migrating", torch.bool, "P"), ("mass", torch.int32, "P"), ("contig", torch.bool, "P"),
    ("cand_u", torch.float32, "PK1"), ("addr_eps", torch.float32, "PK"),
    ("zstart", torch.int32, "Z"), ("zcount", torch.int32, "Z"), ("zone_id", torch.int32, "N"),
    ("rep_S", torch.float32, "N"), ("rep_H", torch.float32, "N"),
    ("rep_run", torch.float32, "N"), ("rep_t", torch.int32, "N"),
    ("dS", torch.float32, "N"), ("dH", torch.float32, "N"), ("s_true", torch.float32, "N"),
    ("h_true", torch.float32, "N"), ("run_true", torch.float32, "N"), ("t", torch.int32, ""),
)
# the probe columns the address kernel reads by slot, and the ones it writes
ADDRESS_READS = ("st", "node", "zone", "timer", "patience", "migrating", "mass", "contig",
                 "cand_u", "addr_eps")
ADDRESS_WRITES = ("st", "node", "zone", "timer", "patience")


@functools.lru_cache(maxsize=None)
def plan(P: int, K: int) -> LaunchPlan:
    rb = THREADS
    ops = tuple(Operand(n, P, rb) for n in ("s_pred", "h_pred", "eps", "feasible"))
    ops += (Operand("best", P, rb, write=True), Operand("val", P, rb, write=True))
    return LaunchPlan(
        entry="utility_topk",
        source="utility_topk",
        launches=(Launch("utility_topk_kernel", cdiv(P, THREADS), THREADS, ops),) if P else (),
        outputs=(Output("best", (P,), torch.int32), Output("val", (P,), torch.float32)),
    )


def for_call(s_pred, h_pred, eps, feasible, gamma) -> LaunchPlan:
    return plan(s_pred.shape[0], s_pred.shape[1])


@functools.lru_cache(maxsize=None)
def address_plan(P: int, K: int, seeds: int = 0) -> LaunchPlan:
    """The one launch of ``utility_topk_address`` over P slots of K
    candidates; the counts are written whatever P. ``seeds``: 0 for one
    seed's call, else that of a call with a seed axis of that many
    seeds, block row ``blockIdx.y`` on seed ``blockIdx.y``'s columns, zones
    and nodes."""
    if seeds:
        return batched(address_plan(P, K), seeds)
    if K < 1:
        raise ValueError(f"utility_topk_address: K = {K} candidates; the launchpad is one")
    rb = THREADS
    ops = tuple(Operand(n, P, rb) for n in ADDRESS_READS)
    ops += tuple(Operand(f"{n}_out", P, rb, write=True) for n in ADDRESS_WRITES)
    return LaunchPlan(
        entry="utility_topk_address",
        source="utility_topk",
        launches=(Launch("utility_topk_address_kernel", cdiv(P, THREADS), THREADS, ops),)
        if P else (),
        outputs=(Output("st", (P,), torch.int32), Output("node", (P,), torch.int32),
                 Output("zone", (P,), torch.int32), Output("timer", (P,), torch.int32),
                 Output("patience", (P,), torch.float32), Output("counts", (3,), torch.int32)),
    )


def for_address_call(st, node, zone, timer, patience, migrating, mass, contig, cand_u,
                     addr_eps, *_, **__) -> LaunchPlan:
    """The plan of ``utility_topk_address``, batched when the columns have
    a leading seed axis."""
    return address_plan(st.shape[-1], addr_eps.shape[-1], *st.shape[:-1])
