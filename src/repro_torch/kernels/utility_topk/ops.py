"""utility_topk wrapper: the CUDA kernel for a CUDA tensor, else the plain version."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launch_plan import LaunchPlan
from repro_torch.kernels.utility_topk import plan as _plan
from repro_torch.kernels.utility_topk.ref import utility_topk_ref

__all__ = ["utility_topk"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "utility_topk_launch": [_P, _P, _P, _P, ctypes.c_float, _P, _P, _I, _I, _I, _I, _P],
}


def launch(plan: LaunchPlan, outs, s_pred, h_pred, eps, feasible, gamma) -> None:
    """Launch ``plan`` into ``outs`` (best, val), allocated by the caller."""
    P, K = s_pred.shape
    for x, what in ((s_pred, "s_pred"), (h_pred, "h_pred"), (eps, "eps")):
        _build.expect(x, torch.float32, (P, K), f"utility_topk {what}")
    _build.expect(feasible, torch.bool, (P, K), "utility_topk feasible")
    best, val = outs
    _build.expect(best, torch.int32, (P,), "utility_topk best")
    _build.expect(val, torch.float32, (P,), "utility_topk val")
    if not plan.launches:
        return
    (L,) = plan.launches
    lib = _build.load("utility_topk", _SIG)
    err = lib.utility_topk_launch(
        _build.ptr(s_pred), _build.ptr(h_pred), _build.ptr(eps), _build.ptr(feasible),
        float(gamma), _build.ptr(best), _build.ptr(val), P, K, L.grid, L.block,
        _build.stream(s_pred),
    )
    _build.check(err, "utility_topk")


def utility_topk(
    s_pred: torch.Tensor,
    h_pred: torch.Tensor,
    eps: torch.Tensor,
    feasible: torch.Tensor,
    gamma: float,
):
    """Returns (best_idx (P,) int32, best_score (P,) f32); -3e38 if none feasible.

    ``s_pred``, ``h_pred``, ``eps`` (P, K) float32, ``feasible`` (P, K) bool.
    CPU tensors take :func:`utility_topk_ref`.
    """
    if not s_pred.is_cuda:
        return utility_topk_ref(s_pred, h_pred, eps, feasible, gamma)
    plan = _plan.for_call(s_pred, h_pred, eps, feasible, gamma)
    best, val = plan.new_outputs(s_pred.device)
    launch(plan, (best, val), s_pred, h_pred, eps, feasible, gamma)
    utility_topk.launches += 1
    return best, val


utility_topk.launches = 0
