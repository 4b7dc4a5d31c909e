"""zone_aggregate wrapper: the CUDA kernel for a CUDA tensor, else the plain version."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.zone_aggregate.ref import zone_aggregate_ref

_P = ctypes.c_void_p
_SIG = {"zone_aggregate_launch": [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]}


def zone_aggregate(
    s_gather: torch.Tensor, h_gather: torch.Tensor, mask: torch.Tensor
):
    """Returns (mean slack (Z,), total heat (Z,)) per zone.

    All three inputs (Z, M) float32. CPU tensors take :func:`zone_aggregate_ref`.
    """
    if not s_gather.is_cuda:
        return zone_aggregate_ref(s_gather, h_gather, mask)
    Z, M = s_gather.shape
    for x, what in ((s_gather, "s_gather"), (h_gather, "h_gather"), (mask, "mask")):
        _build.expect(x, torch.float32, (Z, M), f"zone_aggregate {what}")
    zs = torch.empty(Z, dtype=torch.float32, device=s_gather.device)
    zh = torch.empty(Z, dtype=torch.float32, device=s_gather.device)
    lib = _build.load("zone_aggregate", _SIG)
    err = lib.zone_aggregate_launch(
        _build.ptr(s_gather), _build.ptr(h_gather), _build.ptr(mask),
        _build.ptr(zs), _build.ptr(zh), Z, M, _build.stream(s_gather),
    )
    _build.check(err, "zone_aggregate")
    zone_aggregate.launches += 1
    return zs, zh


zone_aggregate.launches = 0
