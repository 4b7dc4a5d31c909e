"""bitmap_fit wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

Four entry points launch the kernels of ``csrc/bitmap_fit.cu``: the flat
``bitmap_fit`` over ``(N, W)`` node rows and the zone-blocked
``bitmap_fit_blocked`` over the ``(Z * M, W)`` rows of a ``(Z, M, W)`` block
launch ``bitmap_fit_kernel``; ``bitmap_fit_rounds`` launches
``bitmap_fit_rounds_kernel``, every arbitration round of a tick in one
cluster launch, and ``bitmap_fit_rounds_blocked`` launches
``bitmap_fit_rounds_blocked_kernel``, the same rounds on one rank's zone
block (the zone-sharded tick's). Given a leading seed axis,
``bitmap_fit_rounds`` runs the flat rounds of B seeds in one launch (one
cluster a seed), and ``bitmap_fit_rounds_op`` is the custom op the tick
calls: the flat wrapper, called once with the seed axis as its batching
rule under ``torch.func.vmap`` (``kernels.batching``). Each wrapper counts
its own launches, so a run can tell which entry it went through. Grid and
block come from the entry's launch plan (``plan.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.kernels import _build
from repro_torch.kernels.batching import dispatch, register_batching
from repro_torch.kernels.bitmap_fit import plan as _plan
from repro_torch.kernels.bitmap_fit.ref import (
    bitmap_fit_blocked_ref,
    bitmap_fit_ref,
    bitmap_fit_rounds_blocked_ref,
    bitmap_fit_rounds_ref,
)
from repro_torch.kernels.launch_plan import LaunchPlan

__all__ = ["bitmap_fit", "bitmap_fit_blocked", "bitmap_fit_rounds", "bitmap_fit_rounds_blocked"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "bitmap_fit_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bitmap_fit_rounds_launch": [_P] * 13 + [_I] * 13 + [_P],
    "bitmap_fit_rounds_blocked_launch": [_P] * 14 + [_I] * 14 + [_P],
    "bitmap_fit_rounds_batched_launch": [_P] * 13 + [_I] * 14 + [_P],
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
    return dispatch(bitmap_fit, _plan.for_call(words, mass, contig), launch, bitmap_fit_ref,
                    words, mass, contig)


def bitmap_fit_blocked(
    words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor
) -> torch.Tensor:
    """Zone-blocked entry: the same kernel over the rows of a block.

    ``words`` (Z, M, W) int32 bit patterns (padding slots zeroed), ``mass``
    (Z, M) int32, ``contig`` (Z, M) bool; returns (Z, M) int32. A padding
    slot gets whatever its words imply; the caller masks it. CPU tensors
    take :func:`bitmap_fit_blocked_ref`.
    """
    return dispatch(bitmap_fit_blocked, _plan.for_blocked_call(words, mass, contig), launch,
                    bitmap_fit_blocked_ref, words, mass, contig)


def _rounds_operands(plan: LaunchPlan, outs, scratch, st, node, ev, mass, contig, words,
                     throttled):
    """Check a rounds call's columns (P,), replicated words (N, W) and
    throttled flags (N,), each with the plan's leading seed axis, and its
    outputs; returns the scratch, allocated unless given."""
    entry, lead, P, (N, W) = plan.entry, plan.lead, st.shape[-1], words.shape[-2:]
    for x, dtype, what in ((st, torch.int32, "st"), (node, torch.int32, "node"),
                           (ev, torch.float32, "ev"), (mass, torch.int32, "mass"),
                           (contig, torch.bool, "contig")):
        _build.expect(x, dtype, (*lead, P), f"{entry} {what}")
    _build.expect(words, torch.int32, (*lead, N, W), f"{entry} words")
    _build.expect(throttled, torch.bool, (*lead, N), f"{entry} throttled")
    for x, o in zip(outs, plan.outputs):
        _build.expect(x, o.dtype, o.shape, f"{entry} {o.name}")
    if scratch is None:
        scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=st.device)
    _build.expect(scratch, torch.int32, (plan.scratch_words,), f"{entry} scratch")
    return scratch


def launch_rounds(
    plan: LaunchPlan, outs, st, node, ev, mass, contig, words, throttled, *, rounds: int,
    atoms: int, policy: str, scratch=None, lib=None,
) -> None:
    """Launch a ``bitmap_fit_rounds`` plan into ``outs`` (winner, feas,
    alloc, round, admit), allocated by the caller: one cluster, or for a
    batched plan B clusters, one a seed, with every tensor's leading seed
    axis (columns (B, P), ``words`` (B, N, W), ``throttled`` (B, N)).
    ``scratch`` (the plan's ``scratch_words`` int32: the election keys, one
    seed's after another) is allocated here unless given; ``lib`` another
    build of the source (a benchmark's), else the port's. Counts nothing."""
    cols = (st, node, ev, mass, contig, words, throttled)
    scratch = _rounds_operands(plan, outs, scratch, *cols)
    lib = lib or _build.load("bitmap_fit", _SIG)
    N, W = words.shape[-2:]
    args = (*(_build.ptr(x) for x in (*cols, *outs, scratch)), st.shape[-1], N, W, int(atoms),
            int(rounds), int(policy == "best"), *_plan.pack(plan))
    if plan.seeds:
        err = lib.bitmap_fit_rounds_batched_launch(*args, plan.seeds, plan.scratch_words,
                                                   _build.stream(st))
    else:
        err = lib.bitmap_fit_rounds_launch(*args, plan.scratch_words, _build.stream(st))
    _build.check(err, plan.entry)


def launch_rounds_blocked(
    plan: LaunchPlan, outs, st, node, ev, mass, contig, words, throttled, member, mask, local, *,
    rounds: int, atoms: int, policy: str, scratch=None,
) -> None:
    """Launch a ``bitmap_fit_rounds_blocked`` plan (one cluster) into
    ``outs`` (winner, feas, alloc), allocated by the caller; ``scratch`` as
    for :func:`launch_rounds`. Counts nothing."""
    cols = (st, node, ev, mass, contig, words, throttled)
    scratch = _rounds_operands(plan, outs, scratch, *cols)
    (N, W), (Zb, M) = words.shape, member.shape
    _build.expect(member, torch.int32, (Zb, M), "bitmap_fit_rounds_blocked member")
    _build.expect(mask, torch.float32, (Zb, M), "bitmap_fit_rounds_blocked mask")
    _build.expect(local, torch.int32, (N,), "bitmap_fit_rounds_blocked local")
    lib = _build.load("bitmap_fit", _SIG)
    err = lib.bitmap_fit_rounds_blocked_launch(
        *(_build.ptr(x) for x in (*cols, member, mask, local, *outs, scratch)),
        st.shape[0], N, Zb * M, W, int(atoms), int(rounds), int(policy == "best"),
        *_plan.pack(plan), plan.scratch_words, _build.stream(st),
    )
    _build.check(err, "bitmap_fit_rounds_blocked")


def rounds_cluster_occupancy(plan: LaunchPlan) -> dict:
    """How the card takes a rounds plan's cluster launch (flat or blocked),
    with the launcher's attributes set: ``clusters`` that can be resident at
    once (``cudaOccupancyMaxActiveClusters``; 0: it cannot launch) and the
    kernel's ``nonportable`` attribute. Needs the card."""
    (L,) = plan.launches
    fn = "bitmap_fit_rounds_cluster_occupancy"
    W = plan.outputs[2].shape[-1]  # alloc (R, N, W) or (R, Zb, M, W)
    lib = _build.load("bitmap_fit", {fn: [_I, _I, _I, _I, _P]})
    out = (ctypes.c_int * 2)()
    blocked = int(plan.entry == "bitmap_fit_rounds_blocked")
    _build.check(getattr(lib, fn)(W, L.cluster, int(L.cluster_nonportable), blocked, out), fn)
    return {"clusters": out[0], "nonportable": out[1]}


def bitmap_fit_rounds(
    st, node, ev, mass, contig, words, throttled, *, rounds: int, atoms: int, policy: str
):
    """Every arbitration round of a tick in one launch: (winner, feas,
    alloc, round, admit), as :func:`bitmap_fit_rounds_ref` defines them.

    Columns (P,): ``st``, ``node``, ``mass`` int32, ``ev`` float32,
    ``contig`` bool; ``words`` (N, W) int32 bit patterns, ``throttled`` (N,)
    bool; ``policy`` ``"best"`` or ``"first"``. With a leading seed axis on
    every tensor (columns (B, P), ``words`` (B, N, W), ``throttled`` (B, N))
    the outputs have it too: one launch of B clusters. CPU tensors take
    :func:`bitmap_fit_rounds_ref`, seed by seed.
    """
    args = (st, node, ev, mass, contig, words, throttled)
    kw = dict(rounds=rounds, atoms=atoms, policy=policy)
    return dispatch(bitmap_fit_rounds, _plan.for_rounds_call(*args, **kw), launch_rounds,
                    bitmap_fit_rounds_ref, *args, **kw)


def bitmap_fit_rounds_blocked(
    st, node, ev, mass, contig, words, throttled, member, mask, local, *, rounds: int,
    atoms: int, policy: str,
):
    """The arbitration rounds of a tick on one rank's zone block, in one
    launch: (winner, feas, alloc), each ``(R, Zb, M, ...)``, as
    :func:`bitmap_fit_rounds_blocked_ref` defines them.

    The columns, ``words`` and ``throttled`` as :func:`bitmap_fit_rounds`
    takes them (replicated); ``member`` (Zb, M) int32, ``mask`` (Zb, M)
    float32, ``local`` (N,) int32 node -> its slot in the block or -1. CPU
    tensors take :func:`bitmap_fit_rounds_blocked_ref`.
    """
    args = (st, node, ev, mass, contig, words, throttled, member, mask, local)
    kw = dict(rounds=rounds, atoms=atoms, policy=policy)
    return dispatch(bitmap_fit_rounds_blocked, _plan.for_rounds_blocked_call(*args, **kw),
                    launch_rounds_blocked, bitmap_fit_rounds_blocked_ref, *args, **kw)


bitmap_fit.launches = 0
bitmap_fit_blocked.launches = 0
bitmap_fit_rounds.launches = 0
bitmap_fit_rounds_blocked.launches = 0


@torch.library.custom_op("repro_torch::bitmap_fit_rounds", mutates_args=(),
                         device_types=("cpu", "cuda"))
def bitmap_fit_rounds_op(
    st: Tensor, node: Tensor, ev: Tensor, mass: Tensor, contig: Tensor, words: Tensor,
    throttled: Tensor, *, rounds: int, atoms: int, policy: str,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """:func:`bitmap_fit_rounds` as a custom op (the wrapper, looked up at
    each call); under ``vmap``, one call of it with the seed axis."""
    return bitmap_fit_rounds(st, node, ev, mass, contig, words, throttled, rounds=rounds,
                             atoms=atoms, policy=policy)


@bitmap_fit_rounds_op.register_fake
def _(st, node, ev, mass, contig, words, throttled, *, rounds, **_):
    (N, W), P = words.shape, st.shape[0]
    return (st.new_empty((rounds, N)), st.new_empty((rounds, N), dtype=torch.bool),
            st.new_empty((rounds, N, W)), st.new_empty((P,)),
            st.new_empty((P,), dtype=torch.bool))


register_batching(bitmap_fit_rounds_op, bitmap_fit_rounds)
