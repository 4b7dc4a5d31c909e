"""Launch plans of ``csrc/zone_aggregate.cu``: a warp a zone row.

Both entries launch ``zone_aggregate_kernel``: ``ceil(Z / 32)`` CTAs of
``min(Z, 32)`` warps, warp ``w`` of CTA ``b`` on zone row ``32 b + w``.
``zone_aggregate`` reads the ``(Z, M)`` tiles by row; ``zone_aggregate_members``
reads the member index and mask by row and the node vectors at the members
(data-dependent rows, not listed).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.launch_plan import Launch, LaunchPlan, Operand, Output, batched, cdiv

KERNELS = ("zone_aggregate_kernel",)  # the order of zone_aggregate_attrs
MAX_WARPS = 32  # kMaxThreads / 32 of csrc/zone_aggregate.cu


@functools.lru_cache(maxsize=None)
def plan(entry: str, Z: int, M: int, seeds: int = 0) -> LaunchPlan:
    """``entry``'s one launch over Z zone rows of M slots. ``seeds``: 0 for
    one seed's call, else that of a call with a seed axis of that many
    seeds: grid (ceil(Z / warps), seeds), block row ``blockIdx.y`` on seed
    ``blockIdx.y``'s node vectors, members and table."""
    if seeds:
        return batched(plan(entry, Z, M), seeds)
    warps = min(Z, MAX_WARPS)
    rows = ("s_gather", "h_gather", "mask") if entry == "zone_aggregate" else ("member", "mask")
    ops = tuple(Operand(n, Z, warps) for n in rows)
    ops += (Operand("zs", Z, warps, write=True), Operand("zh", Z, warps, write=True))
    return LaunchPlan(
        entry=entry,
        source="zone_aggregate",
        launches=(
            Launch("zone_aggregate_kernel", cdiv(Z, warps), 32 * warps, ops),
        ) if Z else (),
        outputs=(Output("zs", (Z,), torch.float32), Output("zh", (Z,), torch.float32)),
    )


def for_call(s_gather, h_gather, mask) -> LaunchPlan:
    return plan("zone_aggregate", s_gather.shape[0], s_gather.shape[1])


def for_members_call(rep_S, rep_H, member, mask, *_, **__) -> LaunchPlan:
    """The plan of ``zone_aggregate_members``, batched when the member
    index has a leading seed axis."""
    return plan("zone_aggregate_members", *member.shape[-2:], *member.shape[:-2])
