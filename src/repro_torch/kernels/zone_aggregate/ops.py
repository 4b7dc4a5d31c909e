"""zone_aggregate wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

Both entries launch the one ``zone_aggregate_kernel`` of
``csrc/zone_aggregate.cu`` and count their own launches:
``zone_aggregate`` on gathered ``(Z, M)`` tiles (the TPU kernel's
function), ``zone_aggregate_members`` on the node vectors and the zone member
index, with the TEG refresh's select when given the tick.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launch_plan import LaunchPlan
from repro_torch.kernels.zone_aggregate import plan as _plan
from repro_torch.kernels.zone_aggregate.ref import zone_aggregate_members_ref, zone_aggregate_ref

__all__ = ["zone_aggregate", "zone_aggregate_members"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "zone_aggregate_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _opt(x) -> ctypes.c_void_p:
    """A tensor's pointer, or a null pointer for None."""
    return ctypes.c_void_p(None) if x is None else _build.ptr(x)


def _launch(plan, outs, s, h, member, mask, t=None, zS=None, zH=None, every=1) -> None:
    Z, M = mask.shape
    zs, zh = outs
    _build.expect(zs, torch.float32, (Z,), f"{plan.entry} zs")
    _build.expect(zh, torch.float32, (Z,), f"{plan.entry} zh")
    if not plan.launches:
        return
    (L,) = plan.launches
    ptr = _build.ptr
    err = _build.load("zone_aggregate", _SIG).zone_aggregate_launch(
        ptr(s), ptr(h), _opt(member), ptr(mask), _opt(t), int(every), _opt(zS), _opt(zH),
        ptr(zs), ptr(zh), Z, M, L.grid, L.block, _build.stream(mask),
    )
    _build.check(err, plan.entry)


def launch(plan: LaunchPlan, outs, s_gather, h_gather, mask) -> None:
    """Launch a ``zone_aggregate`` plan into ``outs`` (zs, zh), allocated
    by the caller: the tiles under the identity member index."""
    Z, M = s_gather.shape
    for x, what in ((s_gather, "s_gather"), (h_gather, "h_gather"), (mask, "mask")):
        _build.expect(x, torch.float32, (Z, M), f"zone_aggregate {what}")
    _launch(plan, outs, s_gather, h_gather, None, mask)


def launch_members(plan: LaunchPlan, outs, rep_S, rep_H, member, mask, t=None, zS=None,
                   zH=None, *, every: int = 1) -> None:
    """Launch a ``zone_aggregate_members`` plan into ``outs`` (zs, zh),
    allocated by the caller. Counts nothing."""
    N, (Z, M) = rep_S.shape[0], member.shape
    _build.expect(rep_S, torch.float32, (N,), "zone_aggregate_members rep_S")
    _build.expect(rep_H, torch.float32, (N,), "zone_aggregate_members rep_H")
    _build.expect(member, torch.int32, (Z, M), "zone_aggregate_members member")
    _build.expect(mask, torch.float32, (Z, M), "zone_aggregate_members mask")
    if t is not None:
        _build.expect(t, torch.int32, (), "zone_aggregate_members t")
        _build.expect(zS, torch.float32, (Z,), "zone_aggregate_members zS")
        _build.expect(zH, torch.float32, (Z,), "zone_aggregate_members zH")
        if every < 1:
            raise ValueError(f"zone_aggregate_members: refresh every {every} ticks")
    _launch(plan, outs, rep_S, rep_H, member, mask, t, zS, zH, every)


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


def zone_aggregate_members(
    rep_S: torch.Tensor,
    rep_H: torch.Tensor,
    member: torch.Tensor,
    mask: torch.Tensor,
    t: torch.Tensor | None = None,
    zS: torch.Tensor | None = None,
    zH: torch.Tensor | None = None,
    *,
    every: int = 1,
):
    """Per-zone (mean slack (Z,), total heat (Z,)) of the node vectors over
    the zone members, as :func:`zone_aggregate_members_ref` defines them.

    ``rep_S``, ``rep_H`` (N,) float32, ``member`` (Z, M) int32, ``mask``
    (Z, M) float32; ``t`` the tick (int32 scalar on the device) with the old
    ``zS``, ``zH`` (Z,) for the refresh select, decided in the kernel: no
    host sync. The outputs are new tensors, never the old table. CPU tensors
    take the plain version.
    """
    args = (rep_S, rep_H, member, mask, t, zS, zH)
    if not rep_S.is_cuda:
        return zone_aggregate_members_ref(*args, every=every)
    plan = _plan.for_members_call(*args)
    outs = plan.new_outputs(rep_S.device)
    launch_members(plan, outs, *args, every=every)
    zone_aggregate_members.launches += 1
    return tuple(outs)


zone_aggregate.launches = 0
zone_aggregate_members.launches = 0
