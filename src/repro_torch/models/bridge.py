"""Parameters and caches between the reference's numpy trees and this port.

The reference's parameter pytree, as nested dicts of numpy arrays (the
caches' ``KVCache`` leaves as any ``(k, v, pos)`` tuple), becomes the
port's tree of tensors on ``device`` and back, with identical key paths.
bfloat16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses: it crosses as its uint16 bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import tree_map


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a.dtype):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as JAX hands it out

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device) -> dict:
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree) -> dict:
    return tree_map(tensor_to_numpy, tree)


def cache_from_numpy(tree, device) -> dict:
    """``{"b<i>": (k, v, pos)}`` of numpy arrays -> ``{"b<i>": KVCache}``."""
    return {
        name: KVCache(*(tensor_from_numpy(a, device) for a in entry))
        for name, entry in tree.items()
    }


def cache_to_numpy(tree) -> dict:
    return {name: KVCache(*(tensor_to_numpy(t) for t in entry)) for name, entry in tree.items()}
