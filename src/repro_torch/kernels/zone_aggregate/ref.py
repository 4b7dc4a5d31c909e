"""Plain PyTorch versions of the zone_aggregate kernel (port of the JAX ref).

``zone_aggregate_ref`` is the TPU kernel's function on gathered ``(Z, M)``
tiles; ``zone_aggregate_members_ref`` gathers the tiles from the node
vectors itself and, given the tick, keeps the old table off refresh ticks:
the TEG refresh (``core.teg.refresh``) as one call.
"""

from __future__ import annotations

import torch



def zone_aggregate_ref(
    s_gather: torch.Tensor, h_gather: torch.Tensor, mask: torch.Tensor
):
    m = mask.to(torch.float32)
    cnt = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    zs = torch.sum(s_gather.to(torch.float32) * m, dim=-1) / cnt
    zh = torch.sum(h_gather.to(torch.float32) * m, dim=-1)
    return zs, zh


def zone_aggregate_members_ref(
    rep_S: torch.Tensor,
    rep_H: torch.Tensor,
    member: torch.Tensor,
    mask: torch.Tensor,
    t: torch.Tensor | None = None,
    zS: torch.Tensor | None = None,
    zH: torch.Tensor | None = None,
    *,
    every: int = 1,
):
    """Per-zone (mean slack, total heat) of the node vectors ``rep_S``,
    ``rep_H`` (N,) over the ``(Z, M)`` member index and mask; with the tick
    ``t`` given, the fresh values only where ``t % every == 0`` and the old
    ``zS``, ``zH`` (Z,) elsewhere."""
    zs, zh = zone_aggregate_ref(rep_S[member], rep_H[member], mask)
    if t is None:
        return zs, zh
    due = (t % every) == 0
    return torch.where(due, zs, zS), torch.where(due, zh, zH)
