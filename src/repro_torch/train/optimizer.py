"""Optimizer substrate (no external deps): AdamW with global-norm clipping,
warmup+cosine schedule, and an optional int8 gradient-compression stage with
error feedback for cross-pod all-reduces. A port of
``repro.train.optimizer``.

Numerics follow the jitted reference:

  * a Python constant next to a float32 tensor is a float32 scalar (JAX's
    weak typing), and each elementwise step of ``adamw_update`` is one op
    in the reference's order;
  * a division by a run-time value divides by a device tensor (PyTorch's
    CUDA division by a host scalar multiplies by its reciprocal);
  * ``global_norm`` sums the leaves' squares in JAX's flattening order
    (dict keys sorted).

``adamw_update_`` writes the update into the parameters, moments and
error residual in place under ``torch.no_grad()`` (the reference's jitted
step donates its buffers): the train step's update. ``adamw_update``, the
reference's functional form, runs it on copies and leaves its inputs.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import floatops
from repro_torch.models.blocks import sorted_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # gradient compression (int8 + error feedback) for the DP all-reduce
    compress_grads: bool = False


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any
    nu: Any
    err: Any  # error-feedback residual (only if compress_grads)


def _device(tree) -> torch.device:
    return sorted_leaves(tree)[0].device


def _const(x: float, device) -> torch.Tensor:
    """A float32 constant as a device tensor (a divisor that rounds once):
    a fill on the device, which a CUDA graph can capture (``torch.tensor``
    would copy from pageable host memory). The double rounds to float32
    once, as ``torch.tensor(x, dtype=float32)`` rounds it."""
    return torch.full((), x, dtype=F32, device=device)


def init_opt_state(cfg: OptConfig, params: Any) -> AdamState:
    zeros = lambda p: torch.zeros_like(p, dtype=F32)  # noqa: E731
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        err=tree_map(zeros, params) if cfg.compress_grads else None,
    )


def _cosf(x: np.ndarray) -> np.ndarray:
    """float32 ``cos`` as the reference's jitted CPU program computes it: XLA
    calls the C library's ``cosf`` (which is not correctly rounded, so
    neither ``torch.cos`` nor a rounded float64 cosine equals it)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.argtypes = [ctypes.c_float]
    libm.cosf.restype = ctypes.c_float
    return np.array([libm.cosf(float(v)) for v in x], np.float32)


@functools.lru_cache(maxsize=8)
def lr_table(cfg: OptConfig, device: torch.device) -> torch.Tensor:
    """The schedule at steps 0 .. ``total_steps`` (past it, the last entry),
    a float32 tensor on ``device`` made once (a host-to-device copy: a
    compiled train step's eager first step makes it, before the capture),
    rounded as the jitted reference rounds it: XLA turns each division by a
    constant into a multiply by its float32 reciprocal, contracts ``(1 +
    cos) * c + min_lr_frac`` into a fused multiply-add and calls ``cosf``."""
    f = np.float32
    s = np.arange(cfg.total_steps + 1, dtype=f)
    warm = s * f(floatops.recip(max(cfg.warmup_steps, 1)))
    prog = np.clip((s + f(-cfg.warmup_steps))
                   * f(floatops.recip(max(cfg.total_steps - cfg.warmup_steps, 1))), f(0), f(1))
    c = np.float64(f((1 - cfg.min_lr_frac) * 0.5))
    cos = ((_cosf(prog * f(math.pi)) + f(1)).astype(np.float64) * c
           + np.float64(f(cfg.min_lr_frac))).astype(f)
    return torch.from_numpy(np.where(s < cfg.warmup_steps, warm, cos) * f(cfg.lr)).to(device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup then cosine: the entries of :func:`lr_table` at ``step`` (one
    gather on the step's device, no host sync; ``index_select``, as a 0-d
    index into a DTensor step would be read on the host)."""
    idx = torch.clamp(step, 0, cfg.total_steps).long()
    return torch.index_select(lr_table(cfg, step.device), 0, idx.reshape(-1)).reshape(idx.shape)


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale). The
    division by 127 is a multiply by its float32 reciprocal, as XLA folds it."""
    scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) * floatops.recip(127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def apply_compression(cfg: OptConfig, grads: Any, err: Any) -> Tuple[Any, Any]:
    """Quantize grads (+error feedback); the decompressed value is what the
    optimizer consumes, the residual is carried to the next step. The int8
    payload is what would cross the pod-level DP all-reduce."""
    def one(g, e):
        g32 = g.to(F32) + e
        q, s = compress_int8(g32)
        d = decompress_int8(q, s)
        return d, g32 - d

    pairs = tree_map(lambda g, e: one(g, e), grads, err)
    deq = _pick(pairs, grads, 0)
    new_err = _pick(pairs, grads, 1)
    return deq, new_err


def _pick(pairs, like, i):
    """Field ``i`` of the tuples at the leaves of ``pairs`` (shaped as
    ``like``)."""
    if isinstance(like, dict):
        return {k: _pick(pairs[k], like[k], i) for k in like}
    return pairs[i]


def global_norm(tree: Any) -> torch.Tensor:
    total = None
    for g in sorted_leaves(tree):
        sq = torch.sum(g.to(F32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _step_scalars(cfg: OptConfig, grads: Any, step: torch.Tensor):
    """The update's scalars: grad norm, clip scale, new step, lr and the
    bias corrections (device tensors)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(_const(cfg.clip_norm, gnorm.device) / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = step + 1
    lr = schedule(cfg, step)
    sf = step.to(F32)
    b1c = 1 - torch.pow(_const(cfg.b1, sf.device), sf)
    b2c = 1 - torch.pow(_const(cfg.b2, sf.device), sf)
    return gnorm, scale, step, lr, b1c, b2c


def _moments(cfg: OptConfig, g, mu, nu, scale):
    g = g.to(F32) * scale
    mu = cfg.b1 * mu + (1 - cfg.b1) * g
    nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
    return mu, nu


def _delta(cfg: OptConfig, p, mu, nu, b1c, b2c):
    mhat = mu / b1c
    nhat = nu / b2c
    return mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p.to(F32)


@torch.no_grad()
def adamw_update_(
    cfg: OptConfig, params: Any, grads: Any, st: AdamState
) -> Tuple[Any, AdamState, dict]:
    """The AdamW step written into the parameters, moments and error
    residual in place; returns them, the new state and ``{"grad_norm",
    "lr"}``. One leaf's temporaries at a time."""
    if cfg.compress_grads:
        deq, new_err = apply_compression(cfg, grads, st.err)
        for e, n in zip(sorted_leaves(st.err), sorted_leaves(new_err)):
            e.copy_(n)
        grads, new_err = deq, st.err
    else:
        new_err = st.err
    gnorm, scale, step, lr, b1c, b2c = _step_scalars(cfg, grads, st.step)
    for p, g, mu, nu in zip(*(sorted_leaves(t) for t in (params, grads, st.mu, st.nu))):
        m, n = _moments(cfg, g, mu, nu, scale)
        mu.copy_(m)
        nu.copy_(n)
        delta = _delta(cfg, p, mu, nu, b1c, b2c)
        p.copy_((p.to(F32) - lr * delta).to(p.dtype))
    st.step.copy_(step)
    return params, AdamState(step=st.step, mu=st.mu, nu=st.nu, err=new_err), {
        "grad_norm": gnorm, "lr": lr}



def adamw_update(
    cfg: OptConfig, params: Any, grads: Any, st: AdamState
) -> Tuple[Any, AdamState, dict]:
    """The functional update: new params and state, and ``{"grad_norm",
    "lr"}``; ``adamw_update_`` on copies, the inputs left as they were."""
    copy = lambda t: None if t is None else tree_map(torch.clone, t)  # noqa: E731
    return adamw_update_(cfg, copy(params), grads,
                         AdamState(*(copy(x) for x in st)))
