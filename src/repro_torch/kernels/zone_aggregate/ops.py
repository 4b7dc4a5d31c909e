"""zone_aggregate wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

Both entries launch the one ``zone_aggregate_kernel`` of
``csrc/zone_aggregate.cu`` and count their own launches:
``zone_aggregate`` on gathered ``(Z, M)`` tiles (the TPU kernel's
function), ``zone_aggregate_members`` on the node vectors and the zone member
index, with the TEG refresh's select when given the tick, and given a
leading seed axis the refresh of B seeds in one launch.
``zone_aggregate_members_op`` is the custom op the tick calls: the wrapper,
called once with the seed axis as its batching rule under
``torch.func.vmap`` (``kernels.batching``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import Tensor

from repro_torch.kernels import _build
from repro_torch.kernels.batching import dispatch, register_batching
from repro_torch.kernels.launch_plan import LaunchPlan
from repro_torch.kernels.zone_aggregate import plan as _plan
from repro_torch.kernels.zone_aggregate.ref import zone_aggregate_members_ref, zone_aggregate_ref

__all__ = ["zone_aggregate", "zone_aggregate_members"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "zone_aggregate_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "zone_aggregate_batched_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P] + [_I] * 6 + [_P],
}


def _opt(x) -> ctypes.c_void_p:
    """A tensor's pointer, or a null pointer for None."""
    return ctypes.c_void_p(None) if x is None else _build.ptr(x)


def _launch(plan, outs, s, h, member, mask, t=None, zS=None, zH=None, every=1, N=0,
            lib=None) -> None:
    Z, M = mask.shape[-2:]
    zs, zh = outs
    _build.expect(zs, torch.float32, (*plan.lead, Z), f"{plan.entry} zs")
    _build.expect(zh, torch.float32, (*plan.lead, Z), f"{plan.entry} zh")
    if not plan.launches:
        return
    (L,) = plan.launches
    ptr = _build.ptr
    lib = lib or _build.load("zone_aggregate", _SIG)
    args = (ptr(s), ptr(h), _opt(member), ptr(mask), _opt(t), int(every), _opt(zS), _opt(zH),
            ptr(zs), ptr(zh), Z, M)
    if plan.seeds:
        err = lib.zone_aggregate_batched_launch(*args, N, L.grid, L.block, plan.seeds,
                                                _build.stream(mask))
    else:
        err = lib.zone_aggregate_launch(*args, L.grid, L.block, _build.stream(mask))
    _build.check(err, plan.entry)


def launch(plan: LaunchPlan, outs, s_gather, h_gather, mask) -> None:
    """Launch a ``zone_aggregate`` plan into ``outs`` (zs, zh), allocated
    by the caller: the tiles under the identity member index."""
    Z, M = s_gather.shape
    for x, what in ((s_gather, "s_gather"), (h_gather, "h_gather"), (mask, "mask")):
        _build.expect(x, torch.float32, (Z, M), f"zone_aggregate {what}")
    _launch(plan, outs, s_gather, h_gather, None, mask)


def launch_members(plan: LaunchPlan, outs, rep_S, rep_H, member, mask, t=None, zS=None,
                   zH=None, *, every: int = 1, lib=None) -> None:
    """Launch a ``zone_aggregate_members`` plan into ``outs`` (zs, zh),
    allocated by the caller; for a batched plan every tensor has a leading
    seed axis (``rep_S``, ``rep_H`` (B, N), ``member``, ``mask`` (B, Z, M),
    ``t`` (B,) with ``zS``, ``zH`` (B, Z)). ``lib`` another build of the
    source (a benchmark's), else the port's. Counts nothing."""
    lead, N, (Z, M) = plan.lead, rep_S.shape[-1], member.shape[-2:]
    e = plan.entry
    _build.expect(rep_S, torch.float32, (*lead, N), f"{e} rep_S")
    _build.expect(rep_H, torch.float32, (*lead, N), f"{e} rep_H")
    _build.expect(member, torch.int32, (*lead, Z, M), f"{e} member")
    _build.expect(mask, torch.float32, (*lead, Z, M), f"{e} mask")
    if t is not None:
        _build.expect(t, torch.int32, lead, f"{e} t")
        _build.expect(zS, torch.float32, (*lead, Z), f"{e} zS")
        _build.expect(zH, torch.float32, (*lead, Z), f"{e} zH")
        if every < 1:
            raise ValueError(f"{e}: refresh every {every} ticks")
    _launch(plan, outs, rep_S, rep_H, member, mask, t, zS, zH, every, N, lib)


def zone_aggregate(
    s_gather: torch.Tensor, h_gather: torch.Tensor, mask: torch.Tensor
):
    """Returns (mean slack (Z,), total heat (Z,)) per zone.

    All three inputs (Z, M) float32. CPU tensors take :func:`zone_aggregate_ref`.
    """
    return dispatch(zone_aggregate, _plan.for_call(s_gather, h_gather, mask), launch,
                    zone_aggregate_ref, s_gather, h_gather, mask)


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
    host sync. With a leading seed axis on every tensor (the tick (B,)) the
    outputs are (B, Z): one launch for all seeds. The outputs are new
    tensors, never the old table. CPU tensors take the plain version, seed
    by seed.
    """
    args = (rep_S, rep_H, member, mask, t, zS, zH)
    return dispatch(zone_aggregate_members, _plan.for_members_call(*args), launch_members,
                    zone_aggregate_members_ref, *args, every=every)


zone_aggregate.launches = 0
zone_aggregate_members.launches = 0


@torch.library.custom_op("repro_torch::zone_aggregate_members", mutates_args=(),
                         device_types=("cpu", "cuda"))
def zone_aggregate_members_op(
    rep_S: Tensor, rep_H: Tensor, member: Tensor, mask: Tensor, t: Optional[Tensor] = None,
    zS: Optional[Tensor] = None, zH: Optional[Tensor] = None, *, every: int = 1,
) -> Tuple[Tensor, Tensor]:
    """:func:`zone_aggregate_members` as a custom op (the wrapper, looked up
    at each call); under ``vmap``, one call of it with the seed axis."""
    return zone_aggregate_members(rep_S, rep_H, member, mask, t, zS, zH, every=every)


@zone_aggregate_members_op.register_fake
def _(rep_S, rep_H, member, mask, *_, **__):
    Z = member.shape[0]
    return rep_S.new_empty((Z,)), rep_S.new_empty((Z,))


register_batching(zone_aggregate_members_op, zone_aggregate_members)
