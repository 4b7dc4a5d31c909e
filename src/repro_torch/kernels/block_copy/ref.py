"""Plain PyTorch version of the block_copy kernel: the plan interpreter.

Executes a block-copy plan block by block with torch ops, as Pallas runs a
``pallas_call`` under ``interpret=True`` on the CPU: the output starts as
NaN, so a block that no grid point visits stays NaN, and a block that lies
past the array is clamped to the last block inside it, as ``dynamic_slice``
and ``dynamic_update_slice`` clamp their start. The kernel does not clamp;
that one difference is what the guard bands of ``chip_smoke.py`` show.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.launch_plan import LaunchPlan


def _clamp(lo: int, size: int, n: int) -> int:
    return min(max(lo, 0), n - size)


def block_copy_ref(x: torch.Tensor, plan: LaunchPlan) -> torch.Tensor:
    """``x`` (n,) float32 copied under ``plan``."""
    (o,) = plan.outputs
    out = torch.full(o.shape, float("nan"), dtype=o.dtype, device=x.device)
    for L in plan.launches:
        src, dst = L.operands
        B = dst.rows_per_block
        for b in range(L.grid):
            i = _clamp(src.span(b)[0], B, x.shape[0])
            j = _clamp(dst.span(b)[0], B, out.shape[0])
            out[j : j + B] = x[i : i + B]
    return out
