"""bitmap_fit wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

Two entry points launch the one kernel of ``csrc/bitmap_fit.cu``: the flat
``bitmap_fit`` over ``(N, W)`` node rows and the zone-blocked
``bitmap_fit_blocked`` over the ``(Z * M, W)`` rows of a ``(Z, M, W)`` block.
Each counts its own launches, so a run can tell which entry it went through.
Grid and block come from the entry's launch plan (``plan.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_fit import plan as _plan
from repro_torch.kernels.bitmap_fit.ref import bitmap_fit_blocked_ref, bitmap_fit_ref
from repro_torch.kernels.launch_plan import LaunchPlan

__all__ = ["bitmap_fit", "bitmap_fit_blocked"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "bitmap_fit_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
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


bitmap_fit.launches = 0
bitmap_fit_blocked.launches = 0
