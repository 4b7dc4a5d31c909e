"""utility_topk wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

``utility_topk`` launches ``utility_topk_kernel`` on scored ``(P, K)`` tiles
(the TPU kernel's function); ``utility_topk_address`` launches
``utility_topk_address_kernel``, the whole DA addressing step over the probe
table. Each counts its own launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launch_plan import LaunchPlan
from repro_torch.kernels.utility_topk import plan as _plan
from repro_torch.kernels.utility_topk.ref import utility_topk_address_ref, utility_topk_ref

__all__ = ["utility_topk", "utility_topk_address"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "utility_topk_launch": [_P, _P, _P, _P, ctypes.c_float, _P, _P, _I, _I, _I, _I, _P],
    "utility_topk_address_launch": [_P, _P, _P, _I, _I, _P],
}
# its scalars, in the order of the launcher's floats
_ADDRESS_FLOATS = ("gamma", "sigma", "stay_margin", "eval_cost", "bounce_cost",
                   "fastfail_floor", "tau", "dt_ms", "degrade_after_ms", "degrade_halflife_ms")


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


def launch_address(plan: LaunchPlan, outs, *args, projection: bool, lib=None,
                   **scalars) -> None:
    """Launch a ``utility_topk_address`` plan into ``outs`` (st, node, zone,
    timer, patience, counts), allocated by the caller; the launcher zeroes
    ``counts`` first. ``lib`` another build of the source (a benchmark's),
    else the port's. Counts nothing."""
    n_in = len(_plan.ADDRESS_INPUTS)
    if len(args) != n_in:
        raise TypeError(f"utility_topk_address: {len(args)} inputs, want {n_in}")
    P, K = args[9].shape[0], args[9].shape[-1]
    dims = {"P": (P,), "PK1": (P, K - 1), "PK": (P, K), "Z": (args[10].shape[0],),
            "N": (args[13].shape[0],), "": ()}
    for x, (name, dtype, dim) in zip(args, _plan.ADDRESS_INPUTS):
        _build.expect(x, dtype, dims[dim], f"utility_topk_address {name}")
    for x, o in zip(outs, plan.outputs):
        _build.expect(x, o.dtype, o.shape, f"utility_topk_address {o.name} out")
    if not plan.launches:
        outs[-1].zero_()
        return
    (L,) = plan.launches
    lib = lib or _build.load("utility_topk", _SIG)
    ptrs = (ctypes.c_void_p * 29)(*(x.data_ptr() for x in (*args, *outs)))
    ints = (ctypes.c_int * 4)(P, K, dims["N"][0], int(projection))
    floats = (ctypes.c_float * 10)(*(float(scalars[k]) for k in _ADDRESS_FLOATS))
    err = lib.utility_topk_address_launch(ptrs, ints, floats, L.grid, L.block,
                                          _build.stream(args[0]))
    _build.check(err, "utility_topk_address")


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


def utility_topk_address(*args, **kw):
    """One DA addressing round for every slot with ``st == ADDRESSING``:
    the new ``st``, ``node``, ``zone``, ``timer``, ``patience`` (P,) and the
    int32 counts ``(op_eval, op_bounce, fastfail)``, as
    :func:`utility_topk_address_ref` defines them (its arguments). The
    outputs are new tensors; no input is written. CPU tensors take the
    plain version."""
    if not args[0].is_cuda:
        return utility_topk_address_ref(*args, **kw)
    plan = _plan.for_address_call(*args, **kw)
    outs = plan.new_outputs(args[0].device)
    launch_address(plan, outs, *args, **kw)
    utility_topk_address.launches += 1
    return tuple(outs)


utility_topk.launches = 0
utility_topk_address.launches = 0
