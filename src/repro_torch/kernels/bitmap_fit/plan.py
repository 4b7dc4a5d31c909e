"""Launch plans of ``csrc/bitmap_fit.cu``: one thread per row of words.

Both entries launch the one kernel: ``bitmap_fit`` over the ``(N, W)`` node
rows, ``bitmap_fit_blocked`` over the ``(Z * M, W)`` rows of a zone block.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels.launch_plan import Launch, LaunchPlan, Operand, Output, cdiv

KERNELS = ("bitmap_fit_kernel",)  # the order of bitmap_fit_attrs
THREADS = 256  # kThreads of csrc/bitmap_fit.cu


@functools.lru_cache(maxsize=None)
def plan(entry: str, rows: int, out_shape: Tuple[int, ...]) -> LaunchPlan:
    rb = THREADS
    return LaunchPlan(
        entry=entry,
        source="bitmap_fit",
        launches=(
            Launch(
                "bitmap_fit_kernel", cdiv(rows, THREADS), THREADS,
                (Operand("words", rows, rb), Operand("mass", rows, rb),
                 Operand("contig", rows, rb), Operand("fit", rows, rb, write=True)),
            ),
        ) if rows else (),
        outputs=(Output("fit", out_shape, torch.int32),),
    )


def for_call(words, mass, contig) -> LaunchPlan:
    """The plan of ``bitmap_fit(words, mass, contig)``: (N, W) words."""
    R = words.shape[0]
    return plan("bitmap_fit", R, (R,))


def for_blocked_call(words, mass, contig) -> LaunchPlan:
    """The plan of ``bitmap_fit_blocked``: (Z, M, W) words, (Z, M) out."""
    Z, M = words.shape[0], words.shape[1]
    return plan("bitmap_fit_blocked", Z * M, (Z, M))
