"""bitmap_fit wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

Three entry points launch the kernels of ``csrc/bitmap_fit.cu``: the flat
``bitmap_fit`` over ``(N, W)`` node rows and the zone-blocked
``bitmap_fit_blocked`` over the ``(Z * M, W)`` rows of a ``(Z, M, W)`` block
launch ``bitmap_fit_kernel``; ``bitmap_fit_rounds`` launches
``bitmap_fit_rounds_kernel``, every arbitration round of a tick in one
cluster launch. Each counts its own launches, so a run can tell which entry
it went through. Grid and block come from the entry's launch plan
(``plan.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_fit import plan as _plan
from repro_torch.kernels.bitmap_fit.ref import (
    bitmap_fit_blocked_ref,
    bitmap_fit_ref,
    bitmap_fit_rounds_ref,
)
from repro_torch.kernels.launch_plan import LaunchPlan

__all__ = ["bitmap_fit", "bitmap_fit_blocked", "bitmap_fit_rounds"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "bitmap_fit_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bitmap_fit_rounds_launch": [_P] * 13 + [_I] * 13 + [_P],
}


def launch(plan: LaunchPlan, outs, words, mass, contig) -> None:
    """Launch ``plan`` over the rows of ``words`` into ``outs`` (the plan's
    outputs, allocated by the caller); counts nothing."""
    shape = plan.outputs[0].shape  # (N,) flat, (Z, M) blocked
    R, W = plan.outputs[0].numel(), words.shape[-1]
    (out,) = outs
    _build.expect(words, torch.int32, (*shape, W), "bitmap_fit words")
    _build.expect(mass, torch.int32, shape, "bitmap_fit mass")
    _build.expect(contig, torch.bool, shape, "bitmap_fit contig")
    _build.expect(out, torch.int32, shape, "bitmap_fit out")
    if not plan.launches:
        return
    (L,) = plan.launches
    lib = _build.load("bitmap_fit", _SIG)
    err = lib.bitmap_fit_launch(
        _build.ptr(words), _build.ptr(mass), _build.ptr(contig), _build.ptr(out),
        R, W, L.grid, L.block, _build.stream(words),
    )
    _build.check(err, "bitmap_fit")


def bitmap_fit(
    words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor
) -> torch.Tensor:
    """Feasibility (0/1 int32) of each node's demand against its bitmap.

    ``words`` (N, W) int32 bit patterns, ``mass`` (N,) int32, ``contig``
    (N,) bool. CPU tensors take :func:`bitmap_fit_ref`.
    """
    if not words.is_cuda:
        return bitmap_fit_ref(words, mass, contig)
    plan = _plan.for_call(words, mass, contig)
    outs = plan.new_outputs(words.device)
    launch(plan, outs, words, mass, contig)
    bitmap_fit.launches += 1
    return outs[0]


def bitmap_fit_blocked(
    words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor
) -> torch.Tensor:
    """Zone-blocked entry: the same kernel over the rows of a block.

    ``words`` (Z, M, W) int32 bit patterns (padding slots zeroed), ``mass``
    (Z, M) int32, ``contig`` (Z, M) bool; returns (Z, M) int32. A padding
    slot gets whatever its words imply; the caller masks it. CPU tensors
    take :func:`bitmap_fit_blocked_ref`.
    """
    if not words.is_cuda:
        return bitmap_fit_blocked_ref(words, mass, contig)
    plan = _plan.for_blocked_call(words, mass, contig)
    outs = plan.new_outputs(words.device)
    launch(plan, outs, words, mass, contig)
    bitmap_fit_blocked.launches += 1
    return outs[0]


def launch_rounds(
    plan: LaunchPlan, outs, st, node, ev, mass, contig, words, throttled, *, rounds: int,
    atoms: int, policy: str, scratch=None, lib=None,
) -> None:
    """Launch a ``bitmap_fit_rounds`` plan (one cluster) into ``outs``
    (winner, feas, alloc, round, admit), allocated by the caller;
    ``scratch`` (the plan's ``scratch_words`` int32: the election keys) is
    allocated here unless given; ``lib`` another build of the source (a
    benchmark's), else the port's. Counts nothing."""
    P, (N, W) = st.shape[0], words.shape
    for x, dtype, what in ((st, torch.int32, "st"), (node, torch.int32, "node"),
                           (ev, torch.float32, "ev"), (mass, torch.int32, "mass"),
                           (contig, torch.bool, "contig")):
        _build.expect(x, dtype, (P,), f"bitmap_fit_rounds {what}")
    _build.expect(words, torch.int32, (N, W), "bitmap_fit_rounds words")
    _build.expect(throttled, torch.bool, (N,), "bitmap_fit_rounds throttled")
    for x, o in zip(outs, plan.outputs):
        _build.expect(x, o.dtype, o.shape, f"bitmap_fit_rounds {o.name}")
    if scratch is None:
        scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=st.device)
    _build.expect(scratch, torch.int32, (plan.scratch_words,), "bitmap_fit_rounds scratch")
    lib = lib or _build.load("bitmap_fit", _SIG)
    ptr = _build.ptr
    err = lib.bitmap_fit_rounds_launch(
        *(ptr(x) for x in (st, node, ev, mass, contig, words, throttled, *outs, scratch)),
        P, N, W, int(atoms), int(rounds), int(policy == "best"), *_plan.pack(plan),
        plan.scratch_words, _build.stream(st),
    )
    _build.check(err, "bitmap_fit_rounds")


def rounds_cluster_occupancy(plan: LaunchPlan) -> dict:
    """How the card takes a rounds plan's cluster launch, with the
    launcher's attributes set: ``clusters`` that can be resident at once
    (``cudaOccupancyMaxActiveClusters``; 0: it cannot launch) and the
    kernel's ``nonportable`` attribute. Needs the card."""
    (L,) = plan.launches
    fn = "bitmap_fit_rounds_cluster_occupancy"
    W = plan.outputs[2].shape[2]  # alloc (R, N, W)
    lib = _build.load("bitmap_fit", {fn: [_I, _I, _I, _P]})
    out = (ctypes.c_int * 2)()
    _build.check(getattr(lib, fn)(W, L.cluster, int(L.cluster_nonportable), out), fn)
    return {"clusters": out[0], "nonportable": out[1]}


def bitmap_fit_rounds(
    st, node, ev, mass, contig, words, throttled, *, rounds: int, atoms: int, policy: str
):
    """Every arbitration round of a tick in one launch: (winner, feas,
    alloc, round, admit), as :func:`bitmap_fit_rounds_ref` defines them.

    Columns (P,): ``st``, ``node``, ``mass`` int32, ``ev`` float32,
    ``contig`` bool; ``words`` (N, W) int32 bit patterns, ``throttled`` (N,)
    bool; ``policy`` ``"best"`` or ``"first"``. CPU tensors take
    :func:`bitmap_fit_rounds_ref`.
    """
    args = (st, node, ev, mass, contig, words, throttled)
    kw = dict(rounds=rounds, atoms=atoms, policy=policy)
    if not st.is_cuda:
        return bitmap_fit_rounds_ref(*args, **kw)
    plan = _plan.for_rounds_call(*args, **kw)
    outs = plan.new_outputs(st.device)
    launch_rounds(plan, outs, *args, **kw)
    bitmap_fit_rounds.launches += 1
    return tuple(outs)


bitmap_fit.launches = 0
bitmap_fit_blocked.launches = 0
bitmap_fit_rounds.launches = 0
