"""Parameters, caches and optimizer states between the reference's numpy
trees and this port.

The reference's parameter pytree, as nested dicts of numpy arrays, becomes
the port's tree of tensors on ``device`` and back, with identical key
paths. A cache entry crosses by its class name (``RGLRUState``,
``SSDState``; anything else, such as a plain ``(k, v, pos)`` tuple, is a
``KVCache``), an ``AdamState`` field by field.
bfloat16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses: it crosses as its uint16 bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import tree_map
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.ssd import SSDState

CACHE_TYPES = {"RGLRUState": RGLRUState, "SSDState": SSDState}


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def tensor_from_numpy(a, device) -> torch.Tensor:
    """``a`` as a tensor on ``device`` that shares no memory with it (on the
    CPU a copy; elsewhere the transfer is the copy), of ``a``'s shape (a
    0-d array stays 0-d, where ``np.ascontiguousarray`` makes it 1-d)."""
    a = np.asarray(a, order="C")
    bf16 = _is_bf16(a.dtype)
    if bf16:
        a = a.view(np.uint16)
    if torch.device(device).type == "cpu" or not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


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
    """``{"b<i>": entry}`` of numpy arrays -> the port's cache entries."""
    return {
        name: CACHE_TYPES.get(type(entry).__name__, KVCache)(
            *(tensor_from_numpy(a, device) for a in entry))
        for name, entry in tree.items()
    }


def cache_to_numpy(tree) -> dict:
    return {name: type(entry)(*(tensor_to_numpy(t) for t in entry))
            for name, entry in tree.items()}


def opt_state_from_numpy(st, device):
    """The reference's ``AdamState`` (its leaves numpy arrays) as the port's."""
    from repro_torch.train.optimizer import AdamState  # the optimizer imports models

    err = None if st.err is None else params_from_numpy(st.err, device)
    return AdamState(step=tensor_from_numpy(st.step, device),
                     mu=params_from_numpy(st.mu, device),
                     nu=params_from_numpy(st.nu, device), err=err)


def opt_state_to_numpy(st):
    from repro_torch.train.optimizer import AdamState

    err = None if st.err is None else params_to_numpy(st.err)
    return AdamState(step=tensor_to_numpy(st.step), mu=params_to_numpy(st.mu),
                     nu=params_to_numpy(st.nu), err=err)
