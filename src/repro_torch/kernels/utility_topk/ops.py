"""utility_topk wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

``utility_topk`` launches ``utility_topk_kernel`` on scored ``(P, K)`` tiles
(the TPU kernel's function); ``utility_topk_address`` launches
``utility_topk_address_kernel``, the whole DA addressing step over the probe
table, and ``utility_topk_address_batched`` the same kernel over B seeds in
one launch. Each counts its own launches. ``utility_topk_address_op`` is the
custom op the tick calls: the wrapper, with the batched one as its batching
rule under ``torch.func.vmap`` (``kernels.batching``).
"""

from __future__ import annotations

import ctypes
from contextlib import contextmanager
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.kernels import _build
from repro_torch.kernels.batching import register_batching
from repro_torch.kernels.launch_plan import LaunchPlan
from repro_torch.kernels.utility_topk import plan as _plan
from repro_torch.kernels.utility_topk.ref import (
    utility_topk_address_batched_ref,
    utility_topk_address_ref,
    utility_topk_ref,
)

__all__ = ["utility_topk", "utility_topk_address", "utility_topk_address_batched"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "utility_topk_launch": [_P, _P, _P, _P, ctypes.c_float, _P, _P, _I, _I, _I, _I, _P],
    "utility_topk_address_launch": [_P, _P, _P, _I, _I, _P],
    "utility_topk_address_batched_launch": [_P, _P, _P, _I, _I, _I, _P],
    "utility_topk_capture_id": [_P, _P],
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


_acc_regions: dict = {}  # (device, stream, capture id, seeds) -> word offset in the pool
_acc_owners: list = []  # the lists of owned_regions blocks now open


def accumulator(device: int, stream: int, capture: int, seeds: int) -> int:
    """The word offset, in the address kernel's pool of count accumulators
    (``ACC_POOL_WORDS``, zero when the library loads, left zero by every
    launch that ends), of the region that a launch of ``seeds`` seeds on
    ``stream`` of ``device``, under the CUDA graph capture ``capture`` (0:
    none), sums its counts in: 4 words a seed. Each key gets a region of its
    own, so two launches share one only when one stream orders them or when
    they are replays of one captured graph. A new key takes the lowest free
    words (a released region is reused); a key past the pool is refused."""
    key = (device, stream, capture, seeds)
    off = _acc_regions.get(key)
    if off is None:
        off = 0
        for lo, hi in sorted((o, o + 4 * k[3]) for k, o in _acc_regions.items()
                             if k[0] == device):
            if off + 4 * seeds <= lo:
                break
            off = max(off, hi)
        if off + 4 * seeds > _plan.ACC_POOL_WORDS:
            raise RuntimeError(
                f"utility_topk_address: no count accumulator left for {seeds} seeds on stream "
                f"{stream:#x} of cuda:{device}: {len(_acc_regions)} regions leave no "
                f"{4 * seeds} free words of the pool's {_plan.ACC_POOL_WORDS}")
        _acc_regions[key] = off
        if capture:
            for keys in _acc_owners:
                keys.append(key)
    return off


@contextmanager
def owned_regions():
    """Collect, into the list it yields, the keys of the regions that graph
    captures inside the block take (:func:`accumulator`): their graphs'
    owner gives them back with :func:`release` once the graphs are gone."""
    keys: list = []
    _acc_owners.append(keys)
    try:
        yield keys
    finally:
        _acc_owners.remove(keys)


def release(keys) -> None:
    """Give back the regions of ``keys``: a dropped graph's (its replays
    left them zero)."""
    for key in keys:
        _acc_regions.pop(key, None)


def launch_address(plan: LaunchPlan, outs, *args, projection: bool, lib=None,
                   **scalars) -> None:
    """Launch a ``utility_topk_address`` plan into ``outs`` (st, node, zone,
    timer, patience, counts), allocated by the caller; for a batched plan
    every input and output has a leading seed axis (the tick (B,), counts
    (B, 3)). The kernel writes the counts, through the stream's
    :func:`accumulator`. ``lib`` another build of the source (a
    benchmark's), else the port's. Counts nothing."""
    n_in = len(_plan.ADDRESS_INPUTS)
    if len(args) != n_in:
        raise TypeError(f"{plan.entry}: {len(args)} inputs, want {n_in}")
    lead, P, K = plan.lead, args[9].shape[-2], args[9].shape[-1]
    Z, N = args[10].shape[-1], args[13].shape[-1]
    dims = {"P": (P,), "PK1": (P, K - 1), "PK": (P, K), "Z": (Z,), "N": (N,), "": ()}
    for x, (name, dtype, dim) in zip(args, _plan.ADDRESS_INPUTS):
        _build.expect(x, dtype, (*lead, *dims[dim]), f"{plan.entry} {name}")
    for x, o in zip(outs, plan.outputs):
        _build.expect(x, o.dtype, o.shape, f"{plan.entry} {o.name} out")
    if not plan.launches:
        outs[-1].zero_()
        return
    (L,) = plan.launches
    port = _build.load("utility_topk", _SIG)
    stream = _build.stream(args[0])
    capture = ctypes.c_ulonglong(0)
    _build.check(port.utility_topk_capture_id(stream, ctypes.byref(capture)), plan.entry)
    seeds = plan.seeds or 1
    acc = accumulator(args[0].device.index, stream.value or 0, capture.value, seeds)
    ptrs = (ctypes.c_void_p * 29)(*(x.data_ptr() for x in (*args, *outs)))
    ints = (ctypes.c_int * 6)(P, K, N, int(projection), Z, acc)
    floats = (ctypes.c_float * 10)(*(float(scalars[k]) for k in _ADDRESS_FLOATS))
    lib = lib or port
    if plan.seeds:
        err = lib.utility_topk_address_batched_launch(ptrs, ints, floats, L.grid, L.block,
                                                      plan.seeds, stream)
    else:
        err = lib.utility_topk_address_launch(ptrs, ints, floats, L.grid, L.block, stream)
    _build.check(err, plan.entry)


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


def utility_topk_address_batched(*args, **kw):
    """:func:`utility_topk_address` of B seeds at once: every input with a
    leading seed axis (the tick (B,)), the outputs too (counts (B, 3)). A
    CUDA tensor launches the batched kernel once; CPU tensors take
    :func:`utility_topk_address_batched_ref`, the plain version seed by
    seed."""
    if not args[0].is_cuda:
        return utility_topk_address_batched_ref(*args, **kw)
    plan = _plan.for_address_call(*args, **kw)
    outs = plan.new_outputs(args[0].device)
    launch_address(plan, outs, *args, **kw)
    utility_topk_address_batched.launches += 1
    return tuple(outs)


utility_topk_address_batched.launches = 0


@torch.library.custom_op("repro_torch::utility_topk_address", mutates_args=(),
                         device_types=("cpu", "cuda"))
def utility_topk_address_op(
    st: Tensor, node: Tensor, zone: Tensor, timer: Tensor, patience: Tensor, migrating: Tensor,
    mass: Tensor, contig: Tensor, cand_u: Tensor, addr_eps: Tensor, zstart: Tensor,
    zcount: Tensor, zone_id: Tensor, rep_S: Tensor, rep_H: Tensor, rep_run: Tensor,
    rep_t: Tensor, dS: Tensor, dH: Tensor, s_true: Tensor, h_true: Tensor, run_true: Tensor,
    t: Tensor, *, gamma: float, sigma: float, stay_margin: float, eval_cost: float,
    bounce_cost: float, fastfail_floor: float, projection: bool, tau: float, dt_ms: float,
    degrade_after_ms: float, degrade_halflife_ms: float,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """:func:`utility_topk_address` as a custom op (the wrapper, looked up at
    each call); under ``vmap``, one :func:`utility_topk_address_batched`."""
    return utility_topk_address(
        st, node, zone, timer, patience, migrating, mass, contig, cand_u, addr_eps, zstart,
        zcount, zone_id, rep_S, rep_H, rep_run, rep_t, dS, dH, s_true, h_true, run_true, t,
        gamma=gamma, sigma=sigma, stay_margin=stay_margin, eval_cost=eval_cost,
        bounce_cost=bounce_cost, fastfail_floor=fastfail_floor, projection=projection, tau=tau,
        dt_ms=dt_ms, degrade_after_ms=degrade_after_ms, degrade_halflife_ms=degrade_halflife_ms,
    )


@utility_topk_address_op.register_fake
def _(st, node, zone, timer, patience, *_, **__):
    return (*(x.new_empty(x.shape) for x in (st, node, zone, timer, patience)),
            st.new_empty((3,)))


register_batching(utility_topk_address_op, utility_topk_address_batched)
