"""Plain PyTorch version of the bitmap_fit kernel (port of the JAX ref)."""

from __future__ import annotations

import torch

from repro_torch.core import bitmap


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


def bitmap_fit_blocked_ref(
    words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor
) -> torch.Tensor:
    """Zone-blocked version: ``(Z, M, W)`` words, ``(Z, M)`` demand -> (Z, M).

    Row feasibility does not depend on the blocking, so this is the flat
    version on the flattened rows, reshaped back."""
    Z, M, W = words.shape
    flat = bitmap_fit_ref(words.reshape(Z * M, W), mass.reshape(-1), contig.reshape(-1))
    return flat.reshape(Z, M)
