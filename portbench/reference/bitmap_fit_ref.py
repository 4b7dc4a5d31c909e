"""Plain PyTorch versions of the bitmap_fit kernels (port of the JAX ref).

``bitmap_fit_ref`` is the one-round fit test; ``bitmap_fit_rounds_ref`` is
the arbiter's round (``arbiter.elect``, the fit test and
``arbiter.alloc_round``) run ``rounds`` times, the plain version of the
one-launch ``bitmap_fit_rounds`` kernel.
"""

from __future__ import annotations

import torch

# a module import: arbiter reaches this module through hotpath
from . import arbiter, bitmap


def bitmap_fit_ref(
    words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor
) -> torch.Tensor:
    """Per-node feasibility via the unpacked bit-plane path."""
    W = words.shape[-1]
    bits = bitmap.unpack_bits(words, W * 32)
    free = torch.sum(bits, dim=-1)
    runs = bitmap.max_run(bits)
    m = mass.to(torch.int32)
    ok = torch.where(contig.to(torch.bool), runs >= m, free >= m)
    ok = ok | (m == 0)
    return ok.to(torch.int32)


def bitmap_fit_rounds_ref(
    st: torch.Tensor,
    node: torch.Tensor,
    ev: torch.Tensor,
    mass: torch.Tensor,
    contig: torch.Tensor,
    words: torch.Tensor,
    throttled: torch.Tensor,
    *,
    rounds: int,
    atoms: int,
    policy: str,
):
    """``rounds`` arbitration rounds: a winner leaves the queue whether it is
    admitted or not, and its atoms leave the node's words.

    Columns (P,): ``st``, ``node``, ``mass`` int32, ``ev`` float32,
    ``contig`` bool; ``words`` (N, W) int32 bit patterns, ``throttled`` (N,)
    bool. Returns (winner (R, N) int32 slot or -1, feas (R, N) bool, alloc
    (R, N, W) int32 taken words, round (P,) int32 the round a probe won or
    -1, admit (P,) bool)."""
    P, N = st.shape[0], words.shape[0]
    node_c = torch.clamp(node, 0, N - 1)
    bits = bitmap.unpack_bits(words, atoms)
    won = torch.full((P,), -1, dtype=torch.int32, device=st.device)
    admit = torch.zeros(P, dtype=torch.bool, device=st.device)
    winners, feasible, taken = [], [], []
    for r in range(rounds):
        winner, wslot = arbiter.elect(st, node, ev, throttled)
        has_w = wslot >= 0
        ws = torch.clamp(wslot, 0, max(P - 1, 0))
        w_mass, w_contig = mass[ws], contig[ws]
        fit = bitmap_fit_ref(words, w_mass, w_contig)
        alloc_words, feas, bits = arbiter.alloc_round(bits, w_mass, w_contig, fit, has_w, policy)
        words = words & ~alloc_words
        st = torch.where(winner, -1, st)  # out of the queue
        won = torch.where(winner, r, won)
        admit = torch.where(winner, feas[node_c], admit)
        winners.append(wslot)
        feasible.append(feas)
        taken.append(alloc_words)
    W = words.shape[1]
    dev = st.device
    if not rounds:
        return (torch.zeros((0, N), dtype=torch.int32, device=dev),
                torch.zeros((0, N), dtype=torch.bool, device=dev),
                torch.zeros((0, N, W), dtype=torch.int32, device=dev), won, admit)
    return torch.stack(winners), torch.stack(feasible), torch.stack(taken), won, admit


