"""bitmap_fit wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

Two entry points launch the one kernel of ``csrc/bitmap_fit.cu``: the flat
``bitmap_fit`` over ``(N, W)`` node rows and the zone-blocked
``bitmap_fit_blocked`` over the ``(Z * M, W)`` rows of a ``(Z, M, W)`` block.
Each counts its own launches, so a run can tell which entry it went through.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_fit.ref import bitmap_fit_blocked_ref, bitmap_fit_ref

_P = ctypes.c_void_p
_SIG = {"bitmap_fit_launch": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]}


def _launch(words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor) -> torch.Tensor:
    """Launch the kernel over the rows of (R, W) ``words``; counts nothing."""
    R, W = words.shape
    _build.expect(words, torch.int32, (R, W), "bitmap_fit words")
    _build.expect(mass, torch.int32, (R,), "bitmap_fit mass")
    _build.expect(contig, torch.bool, (R,), "bitmap_fit contig")
    out = torch.empty(R, dtype=torch.int32, device=words.device)
    lib = _build.load("bitmap_fit", _SIG)
    err = lib.bitmap_fit_launch(
        _build.ptr(words), _build.ptr(mass), _build.ptr(contig), _build.ptr(out),
        R, W, _build.stream(words),
    )
    _build.check(err, "bitmap_fit")
    return out


def bitmap_fit(
    words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor
) -> torch.Tensor:
    """Feasibility (0/1 int32) of each node's demand against its bitmap.

    ``words`` (N, W) int32 bit patterns, ``mass`` (N,) int32, ``contig``
    (N,) bool. CPU tensors take :func:`bitmap_fit_ref`.
    """
    if not words.is_cuda:
        return bitmap_fit_ref(words, mass, contig)
    out = _launch(words, mass, contig)
    bitmap_fit.launches += 1
    return out


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
    Z, M, W = words.shape
    _build.expect(words, torch.int32, (Z, M, W), "bitmap_fit_blocked words")
    out = _launch(words.reshape(Z * M, W), mass.reshape(-1), contig.reshape(-1))
    bitmap_fit_blocked.launches += 1
    return out.reshape(Z, M)


bitmap_fit.launches = 0
bitmap_fit_blocked.launches = 0
