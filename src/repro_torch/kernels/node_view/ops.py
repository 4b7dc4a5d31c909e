"""node_view wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

``node_view`` launches ``node_view_kernel`` of ``csrc/node_view.cu`` on one
seed's ``(N, W)`` words or on B seeds' ``(B, N, W)`` in one launch, and
counts its launches. ``node_view_op`` is the custom op the tick calls: the
wrapper, called once with the seed axis as its batching rule under
``torch.func.vmap`` (``kernels.batching``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.kernels import _build
from repro_torch.kernels.batching import dispatch, register_batching
from repro_torch.kernels.launch_plan import LaunchPlan
from repro_torch.kernels.node_view import plan as _plan
from repro_torch.kernels.node_view.ref import node_view_ref

__all__ = ["node_view"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "node_view_launch": [_P, _P, _P] + [_I] * 5 + [_P],
    "node_view_batched_launch": [_P, _P, _P] + [_I] * 6 + [_P],
}


def launch(plan: LaunchPlan, outs, words, *, atoms: int, lib=None) -> None:
    """Launch a ``node_view`` plan into ``outs`` (s, run), allocated by the
    caller; for a batched plan the words and outputs have a leading seed
    axis. ``lib`` another build of the source (a benchmark's), else the
    port's. Counts nothing."""
    lead = plan.lead
    N, W = words.shape[-2:]
    _build.expect(words, torch.int32, (*lead, N, W), f"{plan.entry} words")
    s, run = outs
    _build.expect(s, torch.float32, (*lead, N), f"{plan.entry} s")
    _build.expect(run, torch.float32, (*lead, N), f"{plan.entry} run")
    if not plan.launches:
        return
    (L,) = plan.launches
    lib = lib or _build.load("node_view", _SIG)
    args = (_build.ptr(words), _build.ptr(s), _build.ptr(run), N, W, atoms)
    if plan.seeds:
        err = lib.node_view_batched_launch(*args, L.grid, L.block, plan.seeds,
                                           _build.stream(words))
    else:
        err = lib.node_view_launch(*args, L.grid, L.block, _build.stream(words))
    _build.check(err, plan.entry)


def node_view(words: torch.Tensor, *, atoms: int):
    """Each row's (free atoms (N,), longest free run (N,)), float32, of the
    ``(N, W)`` int32 words whose first ``atoms`` bits are atoms (the bits
    past them count as occupied), as :func:`node_view_ref` computes them.
    Words ``(B, N, W)`` of B seeds give ``(B, N)`` outputs in one launch.
    CPU tensors take the plain version."""
    return dispatch(node_view, _plan.for_call(words, atoms=atoms), launch, node_view_ref, words,
                    atoms=atoms)


node_view.launches = 0


@torch.library.custom_op("repro_torch::node_view", mutates_args=(),
                         device_types=("cpu", "cuda"))
def node_view_op(words: Tensor, *, atoms: int) -> Tuple[Tensor, Tensor]:
    """:func:`node_view` as a custom op (the wrapper, looked up at each
    call); under ``vmap``, one call of it with the seed axis."""
    return node_view(words, atoms=atoms)


@node_view_op.register_fake
def _(words, *, atoms):
    shape = words.shape[:-1]
    return words.new_empty(shape, dtype=torch.float32), words.new_empty(shape, dtype=torch.float32)


register_batching(node_view_op, node_view)
