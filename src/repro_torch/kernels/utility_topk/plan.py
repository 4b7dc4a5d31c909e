"""Launch plan of ``csrc/utility_topk.cu``: one thread per probe row."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.launch_plan import Launch, LaunchPlan, Operand, Output, cdiv

KERNELS = ("utility_topk_kernel",)  # the order of utility_topk_attrs
THREADS = 256  # kThreads of csrc/utility_topk.cu


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
