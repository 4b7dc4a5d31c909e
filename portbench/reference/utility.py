"""Unified utility field (§III-C), a port of ``repro.core.utility``.

    U = log2(1 + S_pred) - gamma * log2(1 + H_pred)

TEG maps zone-level utility to a routing distribution; DA adds a zero-mean
Gaussian perturbation and takes a finite discrete choice. On CUDA the
``utility_topk`` kernel computes the same score with the same operations in
the same order (IEEE ``log2f``, no fused multiply-add), so the launchpad score
below and the kernel's best score compare like for like.
"""

from __future__ import annotations

import math

import torch


def log2p1(x: torch.Tensor) -> torch.Tensor:
    return torch.log2(1.0 + torch.clamp(x, min=0.0))


def unified_utility(s_pred: torch.Tensor, h_pred: torch.Tensor, gamma: float) -> torch.Tensor:
    return log2p1(s_pred) - gamma * log2p1(h_pred)


def zone_routing_logits(zone_utility: torch.Tensor, temperature: float) -> torch.Tensor:
    """P(z) = 2^(U_z/tau) / sum_r 2^(U_r/tau)  ==  softmax(U ln2 / tau)."""
    return zone_utility * (math.log(2.0) / temperature)
