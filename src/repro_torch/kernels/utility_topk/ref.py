"""Plain PyTorch version of the utility_topk kernel (port of the JAX ref)."""

from __future__ import annotations

import torch

NEG = -3.0e38


def utility_topk_ref(
    s_pred: torch.Tensor,
    h_pred: torch.Tensor,
    eps: torch.Tensor,
    feasible: torch.Tensor,
    gamma: float,
):
    score = (
        torch.log2(1.0 + torch.clamp(s_pred.to(torch.float32), min=0.0))
        - gamma * torch.log2(1.0 + torch.clamp(h_pred.to(torch.float32), min=0.0))
        + eps.to(torch.float32)
    )
    score = torch.where(feasible.to(torch.bool), score, NEG)
    # torch.max over a dim returns the first index of the maximum, as jnp.argmax
    val, idx = torch.max(score, dim=-1)
    return idx.to(torch.int32), val
