"""Plain PyTorch version of the zone_aggregate kernel (port of the JAX ref)."""

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
