"""block_copy wrapper: the CUDA kernel for a CUDA tensor, else the plain version.

The kernel runs the plan it is given, good or bad; the plain version is the
plan interpreter (``ref.py``). The output is NaN where the plan writes no
block of it, as under the interpreter: the kernel fills that tail in the
same launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.batching import dispatch
from repro_torch.kernels.block_copy.ref import block_copy_ref
from repro_torch.kernels.launch_plan import LaunchPlan

__all__ = ["block_copy"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "block_copy_launch": [_P, _P, _I, _I, ctypes.c_longlong, _I, _I, _I, _P],
}


def launch(plan: LaunchPlan, outs, x, given: LaunchPlan | None = None) -> None:
    """Launch ``plan`` from ``x`` into ``outs`` (out,), allocated by the
    caller; the launch also sets to NaN what no block of the plan writes.
    ``given``: the wrapper's own plan argument, which is ``plan``."""
    (L,) = plan.launches
    src, dst = L.operands
    _build.expect(x, torch.float32, (src.rows,), "block_copy x")
    (out,) = outs
    _build.expect(out, torch.float32, (dst.rows,), "block_copy out")
    B = dst.rows_per_block
    lib = _build.load("block_copy", _SIG)
    err = lib.block_copy_launch(
        _build.ptr(x), _build.ptr(out), B, src.first // B, dst.rows, L.grid, L.block,
        L.dynamic_smem, _build.stream(x),
    )
    _build.check(err, "block_copy")


def block_copy(x: torch.Tensor, plan: LaunchPlan) -> torch.Tensor:
    """``x`` (n,) float32 copied under ``plan``. CPU tensors take
    :func:`block_copy_ref`."""
    return dispatch(block_copy, plan, launch, block_copy_ref, x, plan)


block_copy.launches = 0
