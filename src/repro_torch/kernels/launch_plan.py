"""Launch plans: the declared geometry of every hand-written kernel launch.

A plan is plain data for given shapes. It lists every launch an entry makes
(kernel name, grid, block, dynamic and declared static shared memory, and for
each block-addressed operand its extent and the rows each block touches), the
outputs' shapes and dtypes, and the scratch carve-outs. The grid is decided
here, once, in Python: the wrapper builds the plan, allocates its outputs from
it and hands grid and block to the C launcher, which computes no geometry of
its own and refuses a block size other than the one it was compiled for.

The same plan is what ``repro_torch.analysis.kernel_contract`` checks on the
CPU (coverage, bounds, the per-block budget and cluster limits, output
shapes) and what
``chip_smoke.py`` holds against ``cudaFuncGetAttributes`` and guard bands on
the card.

Operand rows are the units a launch indexes by block: block ``b`` touches rows
``[first + b * rows_per_block, first + (b + 1) * rows_per_block)``. Accesses
whose row comes from data (scatters by node index) are not listed; the guard
bands of ``chip_smoke.py`` see those.

A batched plan (:func:`batched`, the lockstep engine's seed axis) is the
entry's own plan for a call whose tensors carry a leading seed axis: the
same launches over ``seeds`` seeds at once: ``Launch.seeds`` is a second grid
dimension, every operand's rows are one seed's (seed ``s`` addresses its own
copy of each operand), every output has a leading seed axis, and the scratch
holds one stride of carve-outs a seed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["Carve", "Launch", "LaunchPlan", "Operand", "Output", "batched", "cdiv"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Operand:
    """One block-addressed operand of a launch."""

    name: str
    rows: int  # extent of the operand, in rows
    rows_per_block: int  # rows each block touches
    first: int = 0  # first row of block 0 (an input block offset shifts it)
    write: bool = False

    def span(self, block: int) -> Tuple[int, int]:
        lo = self.first + block * self.rows_per_block
        return lo, lo + self.rows_per_block


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: ``kernel<<<grid, block, dynamic_smem>>>``, in
    clusters of ``cluster`` CTAs (``cudaLaunchAttributeClusterDimension``;
    1: no cluster). A cluster past the portable 8 CTAs needs
    ``cluster_nonportable`` (``cudaFuncAttributeNonPortableClusterSizeAllowed``).
    ``seeds``: the seed axis of a batched launch, a second grid dimension
    (``blockIdx.y``; for a cluster launch, the cluster's index along x:
    ``grid * seeds`` CTAs in all), each seed on its own copy of the
    operands."""

    kernel: str  # the ``__global__`` function's name in the source
    grid: int
    block: int
    operands: Tuple[Operand, ...]
    guarded: bool = True  # threads past an operand's extent return before touching it
    dynamic_smem: int = 0
    static_smem: int = 0  # declared; chip_smoke.py holds it against the compiled kernel
    cluster: int = 1
    cluster_nonportable: bool = False
    seeds: int = 1


@dataclasses.dataclass(frozen=True)
class Output:
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass(frozen=True)
class Carve:
    """A named slice ``[offset, offset + words)`` of the int32 scratch."""

    name: str
    offset: int
    words: int


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Every launch of one entry at one shape, in launch order."""

    entry: str  # the wrapper's name
    source: str  # ``csrc/<source>.cu``
    launches: Tuple[Launch, ...]
    outputs: Tuple[Output, ...]
    scratch_words: int = 0
    scratch: Tuple[Carve, ...] = ()
    seeds: int = 0  # the leading seed axis of a batched plan's tensors; 0: none

    @property
    def lead(self) -> Tuple[int, ...]:
        """The leading axes of every tensor of a call: ``(seeds,)`` for a
        batched plan, else none."""
        return (self.seeds,) if self.seeds else ()

    def new_outputs(self, device) -> list:
        """Uninitialised output tensors, as the plan declares them."""
        return [torch.empty(o.shape, dtype=o.dtype, device=device) for o in self.outputs]


def batched(plan: LaunchPlan, seeds: int, scratch_stride: int = 0) -> LaunchPlan:
    """``plan`` over ``seeds`` seeds in one launch each: the same entry,
    every launch with ``seeds`` set, every output with a
    leading seed axis, and one copy of the scratch carve-outs a seed,
    ``scratch_stride`` words apart."""
    if seeds < 1:
        raise ValueError(f"{plan.entry}: {seeds} seeds; a batch holds at least one")
    return LaunchPlan(
        entry=plan.entry,
        source=plan.source,
        launches=tuple(dataclasses.replace(L, seeds=seeds) for L in plan.launches),
        outputs=tuple(Output(o.name, (seeds,) + o.shape, o.dtype) for o in plan.outputs),
        scratch_words=seeds * scratch_stride,
        scratch=tuple(Carve(f"{c.name}[{b}]", b * scratch_stride + c.offset, c.words)
                      for b in range(seeds) for c in plan.scratch),
        seeds=seeds,
    )
