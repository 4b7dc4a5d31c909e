"""Resource-atom bitmap substrate (plain PyTorch).

A node's allocatable capacity is a fixed-length binary bitmap (1 = free atom).
F-tasks take ``m`` *dispersed* atoms; L-tasks need a *strictly contiguous*
run of ``m`` atoms. A port of ``repro.core.bitmap``.

Words are held as **int32 bit patterns** (PyTorch has few uint32 ops): bit
``k`` of word ``w`` is atom ``32 * w + k``, LSB first, exactly as the JAX
package's uint32 words. ``>>`` on int32 is arithmetic, so shifts that must
bring in zeros go through :func:`shr_logical`.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
_INT32_MAX = 2**31 - 1

# ---------------------------------------------------------------------------
# word <-> bit-plane conversion
# ---------------------------------------------------------------------------


def shr_logical(words: torch.Tensor, k) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by ``k`` (int or tensor,
    0..32): zeros come in from the top, as for uint32 words."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return (w >> k).to(torch.int32)


def unpack_bits(words: torch.Tensor, atoms: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., atoms) bool (LSB-first)."""
    pos = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    # (w >> k) & 1 reads bit k whatever the sign fill of the shift
    bits = (words.to(torch.int32)[..., :, None] >> pos) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return bits[..., :atoms].to(torch.bool)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., atoms) bool -> (..., W) int32 words (LSB-first).

    The per-bit terms are disjoint, so their int32 sum is their OR (bit 31
    enters as -2**31 and no partial sum overflows). The explicit ``dtype``
    keeps ``torch.sum`` from promoting to int64.
    """
    atoms = bits.shape[-1]
    n_words = (atoms + WORD_BITS - 1) // WORD_BITS
    pad = n_words * WORD_BITS - atoms
    if pad:
        bits = torch.cat(
            [bits, bits.new_zeros((*bits.shape[:-1], pad))], dim=-1
        )
    b = bits.reshape(*bits.shape[:-1], n_words, WORD_BITS).to(torch.int32)
    pos = torch.arange(WORD_BITS, dtype=torch.int32, device=bits.device)
    return torch.sum(b << pos, dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# SWAR popcount (per 32-bit word)
# ---------------------------------------------------------------------------


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count via the 5-step SWAR bit trick."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def free_atoms(words: torch.Tensor) -> torch.Tensor:
    """Total free atoms per node: sum of per-word popcounts."""
    return torch.sum(popcount_words(words), dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# contiguous-run analysis on bit planes
# ---------------------------------------------------------------------------


def run_lengths(bits: torch.Tensor) -> torch.Tensor:
    """Per-position length of the contiguous free run ending at that position."""
    idx = torch.arange(bits.shape[-1], dtype=torch.int32, device=bits.device)
    zero_pos = torch.where(bits, -1, idx)
    last_zero = torch.cummax(zero_pos, dim=-1).values
    return torch.where(bits, idx - last_zero, 0)


def max_run(bits: torch.Tensor) -> torch.Tensor:
    """Longest contiguous free run per node."""
    return torch.amax(run_lengths(bits), dim=-1)


# ---------------------------------------------------------------------------
# allocation (vectorized over nodes)
# ---------------------------------------------------------------------------


def run_totals(bits: torch.Tensor) -> torch.Tensor:
    """Total length of the free run each free atom belongs to (0 if occupied)."""
    f = run_lengths(bits)
    b = run_lengths(bits.flip(-1)).flip(-1)
    return torch.where(bits, f + b - 1, 0)


def _rank(key: torch.Tensor) -> torch.Tensor:
    """Position of each element in the ascending order of ``key`` (keys
    unique where it matters: free atoms carry their own index)."""
    order = torch.argsort(key, dim=-1)
    ar = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def alloc_dispersed(bits: torch.Tensor, m: torch.Tensor):
    """Lowest-index ``m`` free atoms (first-fit). Returns (alloc_bits, feasible)."""
    csum = torch.cumsum(bits.to(torch.int32), dim=-1)
    mm = m.to(torch.int32)[..., None]
    alloc = bits & (csum <= mm)
    feasible = csum[..., -1:] >= mm
    return torch.where(feasible, alloc, False), feasible[..., 0]


def alloc_dispersed_bestfit(bits: torch.Tensor, m: torch.Tensor):
    """Best-fit dispersed: consume atoms from the *shortest* free runs first,
    preserving long contiguous runs for L-task demands."""
    A = bits.shape[-1]
    tot = run_totals(bits)
    idx = torch.arange(A, dtype=torch.int32, device=bits.device)
    key = torch.where(bits, tot * (A + 1) + idx, _INT32_MAX)
    rank = _rank(key)
    m = m.to(torch.int32)
    alloc = bits & (rank < m[..., None])
    feasible = torch.sum(bits, dim=-1) >= m
    return torch.where(feasible[..., None], alloc, False), feasible


def alloc_contiguous(bits: torch.Tensor, m: torch.Tensor):
    """First (lowest-index) contiguous run of ``m`` atoms (first-fit)."""
    rl = run_lengths(bits)
    m = m.to(torch.int32)
    idx = torch.arange(bits.shape[-1], dtype=torch.int32, device=bits.device)
    ok = rl >= m[..., None]  # positions where a run of >= m *ends*
    feasible = torch.any(ok, dim=-1) & (m > 0)
    end = torch.argmax(ok.to(torch.int32), dim=-1).to(torch.int32)
    start = end - m + 1
    alloc = (idx >= start[..., None]) & (idx <= end[..., None])
    return torch.where(feasible[..., None], alloc, False), feasible


def alloc_contiguous_bestfit(bits: torch.Tensor, m: torch.Tensor):
    """Best-fit contiguous: place the run inside the *smallest* free run that
    still fits (minimal leftover), earliest position on ties."""
    A = bits.shape[-1]
    rl = run_lengths(bits)
    tot = run_totals(bits)
    m = m.to(torch.int32)
    idx = torch.arange(A, dtype=torch.int32, device=bits.device)
    ok = rl >= m[..., None]
    feasible = torch.any(ok, dim=-1) & (m > 0)
    key = torch.where(ok, tot * (A + 1) + idx, _INT32_MAX)
    end = torch.argmin(key, dim=-1).to(torch.int32)
    start = end - m + 1
    alloc = (idx >= start[..., None]) & (idx <= end[..., None])
    return torch.where(feasible[..., None], alloc, False), feasible


def alloc_for_class(
    bits: torch.Tensor, m: torch.Tensor, contiguous: torch.Tensor, policy: str = "best"
):
    """Dispatch on task class. ``contiguous`` broadcasts against node dims."""
    if policy == "best":
        a_d, f_d = alloc_dispersed_bestfit(bits, m)
        a_c, f_c = alloc_contiguous_bestfit(bits, m)
    else:
        a_d, f_d = alloc_dispersed(bits, m)
        a_c, f_c = alloc_contiguous(bits, m)
    c = contiguous.to(torch.bool)
    alloc = torch.where(c[..., None], a_c, a_d)
    feas = torch.where(c, f_c, f_d)
    return alloc, feas


