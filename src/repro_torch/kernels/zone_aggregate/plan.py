"""Launch plan of ``csrc/zone_aggregate.cu``: one block per zone row."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.launch_plan import Launch, LaunchPlan, Operand, Output

KERNELS = ("zone_aggregate_kernel",)  # the order of zone_aggregate_attrs
THREADS = 128  # kThreads of csrc/zone_aggregate.cu
STATIC_SMEM = 3 * THREADS * 4  # acc_s, acc_h, acc_m


@functools.lru_cache(maxsize=None)
def plan(Z: int, M: int) -> LaunchPlan:
    ops = tuple(Operand(n, Z, 1) for n in ("s_gather", "h_gather", "mask"))
    ops += (Operand("zs", Z, 1, write=True), Operand("zh", Z, 1, write=True))
    return LaunchPlan(
        entry="zone_aggregate",
        source="zone_aggregate",
        launches=(
            Launch("zone_aggregate_kernel", Z, THREADS, ops, static_smem=STATIC_SMEM),
        ) if Z else (),
        outputs=(Output("zs", (Z,), torch.float32), Output("zh", (Z,), torch.float32)),
    )


def for_call(s_gather, h_gather, mask) -> LaunchPlan:
    return plan(s_gather.shape[0], s_gather.shape[1])
