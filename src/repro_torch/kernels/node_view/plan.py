"""Launch plan of ``csrc/node_view.cu``: a thread a node row.

``node_view`` launches ``node_view_kernel`` over the ``(N, W)`` words,
``ceil(N / THREADS)`` CTAs of ``THREADS``, thread ``i`` of CTA ``b`` on row
``THREADS * b + i``; given a leading seed axis, the same kernel over B
seeds (grid ``(ceil(N / THREADS), B)``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.launch_plan import Launch, LaunchPlan, Operand, Output, batched, cdiv

KERNELS = ("node_view_kernel",)  # the order of node_view_attrs
THREADS = 256  # kThreads of csrc/node_view.cu


@functools.lru_cache(maxsize=None)
def plan(N: int, W: int, atoms: int, seeds: int = 0) -> LaunchPlan:
    """One launch over N rows of W words, ``atoms`` bits of each an atom.
    ``seeds``: 0 for one seed's call, else that of a call with a seed axis
    of that many seeds."""
    if W < 1 or not 1 <= atoms <= 32 * W:
        raise ValueError(f"node_view: {atoms} atoms in {W} words of 32 bits")
    if seeds:
        return batched(plan(N, W, atoms), seeds)
    ops = (Operand("words", N, THREADS), Operand("s", N, THREADS, write=True),
           Operand("run", N, THREADS, write=True))
    return LaunchPlan(
        entry="node_view",
        source="node_view",
        launches=(Launch("node_view_kernel", cdiv(N, THREADS), THREADS, ops),) if N else (),
        outputs=(Output("s", (N,), torch.float32), Output("run", (N,), torch.float32)),
    )


def for_call(words, *, atoms: int) -> LaunchPlan:
    """The plan of ``node_view``, batched when the words have a leading
    seed axis."""
    return plan(*words.shape[-2:], atoms, *words.shape[:-2])
