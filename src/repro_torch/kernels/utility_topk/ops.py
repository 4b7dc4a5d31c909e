"""utility_topk wrapper: the CUDA kernel for a CUDA tensor, else the plain version."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.utility_topk.ref import utility_topk_ref

_P = ctypes.c_void_p
_SIG = {
    "utility_topk_launch": [
        _P, _P, _P, _P, ctypes.c_float, _P, _P, ctypes.c_int, ctypes.c_int, _P,
    ]
}


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
    P, K = s_pred.shape
    for x, what in ((s_pred, "s_pred"), (h_pred, "h_pred"), (eps, "eps")):
        _build.expect(x, torch.float32, (P, K), f"utility_topk {what}")
    _build.expect(feasible, torch.bool, (P, K), "utility_topk feasible")
    best = torch.empty(P, dtype=torch.int32, device=s_pred.device)
    val = torch.empty(P, dtype=torch.float32, device=s_pred.device)
    lib = _build.load("utility_topk", _SIG)
    err = lib.utility_topk_launch(
        _build.ptr(s_pred), _build.ptr(h_pred), _build.ptr(eps), _build.ptr(feasible),
        float(gamma), _build.ptr(best), _build.ptr(val), P, K, _build.stream(s_pred),
    )
    _build.check(err, "utility_topk")
    utility_topk.launches += 1
    return best, val


utility_topk.launches = 0
