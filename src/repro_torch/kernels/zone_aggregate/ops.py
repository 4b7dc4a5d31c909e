"""zone_aggregate wrapper: the CUDA kernel for a CUDA tensor, else the plain version."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launch_plan import LaunchPlan
from repro_torch.kernels.zone_aggregate import plan as _plan
from repro_torch.kernels.zone_aggregate.ref import zone_aggregate_ref

__all__ = ["zone_aggregate"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "zone_aggregate_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def launch(plan: LaunchPlan, outs, s_gather, h_gather, mask) -> None:
    """Launch ``plan`` into ``outs`` (zs, zh), allocated by the caller."""
    Z, M = s_gather.shape
    for x, what in ((s_gather, "s_gather"), (h_gather, "h_gather"), (mask, "mask")):
        _build.expect(x, torch.float32, (Z, M), f"zone_aggregate {what}")
    zs, zh = outs
    _build.expect(zs, torch.float32, (Z,), "zone_aggregate zs")
    _build.expect(zh, torch.float32, (Z,), "zone_aggregate zh")
    if not plan.launches:
        return
    (L,) = plan.launches
    lib = _build.load("zone_aggregate", _SIG)
    err = lib.zone_aggregate_launch(
        _build.ptr(s_gather), _build.ptr(h_gather), _build.ptr(mask),
        _build.ptr(zs), _build.ptr(zh), Z, M, L.grid, L.block, _build.stream(s_gather),
    )
    _build.check(err, "zone_aggregate")


def zone_aggregate(
    s_gather: torch.Tensor, h_gather: torch.Tensor, mask: torch.Tensor
):
    """Returns (mean slack (Z,), total heat (Z,)) per zone.

    All three inputs (Z, M) float32. CPU tensors take :func:`zone_aggregate_ref`.
    """
    if not s_gather.is_cuda:
        return zone_aggregate_ref(s_gather, h_gather, mask)
    plan = _plan.for_call(s_gather, h_gather, mask)
    zs, zh = plan.new_outputs(s_gather.device)
    launch(plan, (zs, zh), s_gather, h_gather, mask)
    zone_aggregate.launches += 1
    return zs, zh


zone_aggregate.launches = 0
