"""Launch plans of ``csrc/bitmap_fit.cu``.

``bitmap_fit`` and ``bitmap_fit_blocked`` launch ``bitmap_fit_kernel``, one
thread per row of words: the ``(N, W)`` node rows, or the ``(Z * M, W)``
rows of a zone block.

``bitmap_fit_rounds`` is one launch of one cluster of ``CLUSTER`` CTAs of
``ROUND_THREADS`` threads (grid == cluster) that runs every arbitration
round of a tick, instantiated for the node's words held as ``ceil(W / 2)``
64-bit registers. CTA ``c`` owns the probe slots ``[c * pc, (c + 1) * pc)``,
``pc = ceil(P / CLUSTER)``, and the nodes ``[c * nb, (c + 1) * nb)``, ``nb
= ceil(N / CLUSTER)``; each warp gathers the keys of its queued probes in
``ROUND_STATIC_SMEM`` bytes of static shared memory. The int32 scratch holds
one carve-out, ``keys``: ``R`` 64-bit election keys a node (slot ``r`` of
node ``n`` at key ``r * N + n``). ``mass`` and
``contig`` are read at the winners' slots (data-dependent rows, not
listed). Shapes past the kernel's limits are refused with the limit in the
message: more than ``MAX_WORDS`` words a node, more atoms than the words
hold, more than ``MAX_ROUNDS`` rounds.

``bitmap_fit_rounds_blocked`` launches ``bitmap_fit_rounds_blocked_kernel``,
the same one cluster on one rank's ``(Zb, M)`` zone block: the block's
``Zb * M`` slots take the place of the nodes (``nb = ceil(Zb * M /
CLUSTER)`` slots a CTA, ``R`` keys a slot in the scratch), its outputs are
``(R, Zb, M)``, and it writes no per-probe output. The node words, the
throttled flags and ``local`` are read at the probes' nodes and the slots'
members (data-dependent rows, not listed). It refuses what
:func:`rounds_plan` refuses.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels.launch_plan import (
    Carve,
    Launch,
    LaunchPlan,
    Operand,
    Output,
    batched,
    cdiv,
)

# the order of bitmap_fit_attrs: the rounds kernels (flat, then zone-blocked)
# for 1 to 4 64-bit words a node
KERNELS = ("bitmap_fit_kernel", *(f"bitmap_fit_rounds_kernel<{nw}>" for nw in (1, 2, 3, 4)),
           *(f"bitmap_fit_rounds_blocked_kernel<{nw}>" for nw in (1, 2, 3, 4)))
THREADS = 256  # kThreads of csrc/bitmap_fit.cu
ROUND_THREADS = 512  # kRoundThreads
CLUSTER = 16  # CTAs of the rounds' one cluster
PORTABLE_CLUSTER = 8  # the largest cluster every Hopper part schedules
MAX_WORDS = 8  # kMaxWords: 256 atoms a node
MAX_ROUNDS = 8  # kMaxRounds
CHUNK = 8  # kChunk: steps of 32 slots a warp gathers before its cascades
ROUND_STATIC_SMEM = (ROUND_THREADS // 32) * CHUNK * 32 * 8  # the gathered 64-bit keys


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


def rounds_scratch_words(N: int, R: int) -> int:
    """Int32 words of scratch: ``bitmap_fit_rounds_scratch_words``."""
    return 2 * N * R


def _refuse(entry: str, N: int, W: int, R: int, atoms: int, rows: str = "node") -> None:
    if N < 1:
        raise ValueError(f"{entry}: N = {N}: the cluster needs at least one {rows}")
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"{entry}: W = {W} words a node; the kernel holds 1 to "
                         f"{MAX_WORDS} ({32 * MAX_WORDS} atoms) in registers")
    if not 1 <= atoms <= 32 * W:
        raise ValueError(f"{entry}: {atoms} atoms a node do not fit {W} words "
                         f"(1 to {32 * W})")
    if not 0 <= R <= MAX_ROUNDS:
        raise ValueError(f"{entry}: {R} rounds; one launch runs 0 to {MAX_ROUNDS}")


@functools.lru_cache(maxsize=None)
def rounds_plan(P: int, N: int, W: int, R: int, atoms: int, seeds: int = 0) -> LaunchPlan:
    """The one launch of ``bitmap_fit_rounds`` at (P, N, W, R, atoms). The
    allocation policy changes what the kernel computes, not its geometry.
    ``seeds``: 0 for one seed's call, else that of a call with a seed axis
    of that many seeds: cluster ``b`` on seed ``b``'s columns, words,
    outputs and keys (no cluster barrier spans two seeds)."""
    if seeds:
        return batched(rounds_plan(P, N, W, R, atoms), seeds, rounds_scratch_words(N, R))
    _refuse("bitmap_fit_rounds", N, W, R, atoms)
    pc, nb = cdiv(P, CLUSTER), cdiv(N, CLUSTER)
    ops = tuple(Operand(c, P, pc) for c in ("st", "node", "ev"))
    ops += (Operand("words", N, nb), Operand("throttled", N, nb))
    ops += tuple(Operand(o, N, nb, write=True) for o in ("winner", "feas", "alloc"))
    ops += tuple(Operand(o, P, pc, write=True) for o in ("round", "admit"))
    keys = rounds_scratch_words(N, R)
    return LaunchPlan(
        entry="bitmap_fit_rounds",
        source="bitmap_fit",
        launches=(Launch(f"bitmap_fit_rounds_kernel<{cdiv(W, 2)}>", CLUSTER, ROUND_THREADS, ops,
                         static_smem=ROUND_STATIC_SMEM, cluster=CLUSTER,
                         cluster_nonportable=CLUSTER > PORTABLE_CLUSTER),),
        outputs=(Output("winner", (R, N), torch.int32), Output("feas", (R, N), torch.bool),
                 Output("alloc", (R, N, W), torch.int32), Output("round", (P,), torch.int32),
                 Output("admit", (P,), torch.bool)),
        scratch_words=keys,
        scratch=(Carve("keys", 0, keys),),
    )


def for_rounds_call(st, node, ev, mass, contig, words, throttled, *, rounds: int, atoms: int,
                    **_) -> LaunchPlan:
    """The plan of ``bitmap_fit_rounds``, batched when every argument has a
    leading seed axis."""
    return rounds_plan(st.shape[-1], *words.shape[-2:], int(rounds), int(atoms),
                       *st.shape[:-1])


@functools.lru_cache(maxsize=None)
def rounds_blocked_plan(P: int, N: int, Zb: int, M: int, W: int, R: int, atoms: int) -> LaunchPlan:
    """The one launch of ``bitmap_fit_rounds_blocked`` at (P, N, Zb, M, W,
    R, atoms): N nodes replicated, a (Zb, M) block of them."""
    if N < 1:
        raise ValueError(f"bitmap_fit_rounds_blocked: N = {N}: no node to hold the words of")
    n = Zb * M
    _refuse("bitmap_fit_rounds_blocked", n, W, R, atoms, rows="slot")
    pc, nb = cdiv(P, CLUSTER), cdiv(n, CLUSTER)
    ops = tuple(Operand(c, P, pc) for c in ("st", "node", "ev"))
    ops += (Operand("member", n, nb), Operand("mask", n, nb))
    ops += tuple(Operand(o, n, nb, write=True) for o in ("winner", "feas", "alloc"))
    keys = rounds_scratch_words(n, R)
    return LaunchPlan(
        entry="bitmap_fit_rounds_blocked",
        source="bitmap_fit",
        launches=(Launch(f"bitmap_fit_rounds_blocked_kernel<{cdiv(W, 2)}>", CLUSTER, ROUND_THREADS,
                         ops, static_smem=ROUND_STATIC_SMEM, cluster=CLUSTER,
                         cluster_nonportable=CLUSTER > PORTABLE_CLUSTER),),
        outputs=(Output("winner", (R, Zb, M), torch.int32),
                 Output("feas", (R, Zb, M), torch.bool),
                 Output("alloc", (R, Zb, M, W), torch.int32)),
        scratch_words=keys,
        scratch=(Carve("keys", 0, keys),),
    )


def for_rounds_blocked_call(st, node, ev, mass, contig, words, throttled, member, mask, local, *,
                            rounds: int, atoms: int, **_) -> LaunchPlan:
    """The plan of ``bitmap_fit_rounds_blocked``."""
    Zb, M = member.shape
    return rounds_blocked_plan(st.shape[0], words.shape[0], Zb, M, words.shape[1], int(rounds),
                               int(atoms))


def pack(p: LaunchPlan):
    """A rounds plan (flat or blocked) as the launcher takes it: (grid,
    block, cluster, non-portable, probe slots a CTA, nodes or slots a CTA)."""
    (L,) = p.launches
    return (L.grid, L.block, L.cluster, int(L.cluster_nonportable),
            L.operands[0].rows_per_block, L.operands[3].rows_per_block)
