"""bitmap_fit wrapper: the CUDA kernel for a CUDA tensor, else the plain version."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_fit.ref import bitmap_fit_ref

_P = ctypes.c_void_p
_SIG = {"bitmap_fit_launch": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]}


def bitmap_fit(
    words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor
) -> torch.Tensor:
    """Feasibility (0/1 int32) of each node's demand against its bitmap.

    ``words`` (N, W) int32 bit patterns, ``mass`` (N,) int32, ``contig``
    (N,) bool. CPU tensors take :func:`bitmap_fit_ref`.
    """
    if not words.is_cuda:
        return bitmap_fit_ref(words, mass, contig)
    N, W = words.shape
    _build.expect(words, torch.int32, (N, W), "bitmap_fit words")
    _build.expect(mass, torch.int32, (N,), "bitmap_fit mass")
    _build.expect(contig, torch.bool, (N,), "bitmap_fit contig")
    out = torch.empty(N, dtype=torch.int32, device=words.device)
    lib = _build.load("bitmap_fit", _SIG)
    err = lib.bitmap_fit_launch(
        _build.ptr(words), _build.ptr(mass), _build.ptr(contig), _build.ptr(out),
        N, W, _build.stream(words),
    )
    _build.check(err, "bitmap_fit")
    bitmap_fit.launches += 1
    return out


bitmap_fit.launches = 0
