"""Launch plans of ``csrc/block_copy.cu``: a float32 copy in whole blocks.

Block ``b`` of a plan copies input block ``b + in_block_offset`` to output
block ``b``, staged in ``block_elems * 4`` bytes of dynamic shared memory.
:func:`plan` builds any such plan, good or bad: the known-bad ones of the
analyzer's fixtures are plans of this kind with a short grid, an offset
input map, or a block over the budget.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.launch_plan import Launch, LaunchPlan, Operand, Output

KERNELS = ("block_copy_kernel",)  # the order of block_copy_attrs
THREADS = 256  # kThreads of csrc/block_copy.cu


@functools.lru_cache(maxsize=None)
def plan(n: int, block_elems: int, grid: int, in_block_offset: int = 0) -> LaunchPlan:
    """Copy of (n,) float32 in blocks of ``block_elems``, ``grid`` blocks."""
    B = block_elems
    return LaunchPlan(
        entry="block_copy",
        source="block_copy",
        launches=(
            Launch(
                "block_copy_kernel", grid, THREADS,
                (Operand("x", n, B, first=in_block_offset * B), Operand("out", n, B, write=True)),
                guarded=False, dynamic_smem=B * 4,
            ),
        ),
        outputs=(Output("out", (n,), torch.float32),),
    )


def good_plan(n: int, block_elems: int) -> LaunchPlan:
    """The plan that tiles (n,) exactly: ``n / block_elems`` blocks."""
    if n % block_elems:
        raise ValueError(f"{n} elements do not tile into blocks of {block_elems}")
    return plan(n, block_elems, n // block_elems)


def for_call(x, plan: LaunchPlan) -> LaunchPlan:
    """The plan of ``block_copy(x, plan)``: the one it is given."""
    return plan
