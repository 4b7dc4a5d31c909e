"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): a
port of ``repro.models.rglru``.

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = a ^ (c * r_t),  a = sigmoid(Lambda)   (per-channel decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped in the Griffin recurrent block: linear projections to two branches,
a short temporal conv on the recurrent branch, GeLU gating on the other.
The diagonal linear recurrence runs as the reference's associative scan
(``common.associative_scan``: the odd / even recursion of
``jax.lax.associative_scan`` in whole-tensor ops, log2(S) levels, so the
combines are the reference's) for training and prefill, and as one step
for decode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import floatops
from repro_torch.models import common as cm
from repro_torch.models.common import ArchConfig, Params

C_CONST = 8.0  # Griffin's fixed scaling of the recurrence gate


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, d_rnn) recurrent state
    conv: torch.Tensor  # (B, W-1, d_rnn) temporal-conv tail


def init_rglru_params(gen: torch.Generator, cfg: ArchConfig, conv_width: int = 4) -> Params:
    d, dr = cfg.d_model, cfg.d_rnn or cfg.d_model
    dt = cfg.param_dtype
    # Lambda init so that a = sigmoid(Lambda) ~ U(0.9, 0.999) ^ (1/c)
    u = cm.uniform(gen, (dr,), 0.9, 0.999)
    root = u ** (1.0 / C_CONST)
    lam = torch.log(root / (1 - root))
    return {
        "w_in_rec": cm.dense_init(gen, d, dr, dt),
        "w_in_gate": cm.dense_init(gen, d, dr, dt),
        "conv_w": cm.normal(gen, (conv_width, dr), 0.1, dt),
        "w_a": cm.dense_init(gen, dr, dr, dt),
        "b_a": cm.zeros(gen, (dr,), dt),
        "w_x": cm.dense_init(gen, dr, dr, dt),
        "b_x": cm.zeros(gen, (dr,), dt),
        "lam": lam.to(dt),
        "w_out": cm.dense_init(gen, dr, d, dt),
    }


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return [a1 * a2, floatops.fma(b1, a2, b2)]


def _rglru_scan(
    p: Params, x: torch.Tensor, h0: Optional[torch.Tensor], x32: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagonal linear recurrence via associative scan. x: (B, S, dr);
    ``x32``: x before its rounding to the compute dtype, which the float32
    gating reads (default: x)."""
    f32 = torch.float32
    # the gates are read only as float32: their last step stays unrounded
    r = cm.sigmoid(x @ p["w_a"].to(x.dtype) + p["b_a"].to(x.dtype), f32)
    i = cm.sigmoid(x @ p["w_x"].to(x.dtype) + p["b_x"].to(x.dtype), f32)
    log_a_base = -cm.softplus(-p["lam"].to(f32))  # log sigmoid(lam)
    log_a = C_CONST * r * log_a_base  # (B, S, dr), <= 0
    a = torch.exp(log_a)
    x32 = x.to(f32) if x32 is None else x32
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x32)
    if h0 is not None:
        # fold the carry-in state as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        gated = torch.cat([h0[:, None, :].to(f32), gated], dim=1)

    _, h = cm.associative_scan(_combine, (a, gated), dim=1)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1]


def rglru_block(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, d_model)
    state: Optional[RGLRUState] = None,
) -> Tuple[torch.Tensor, Optional[RGLRUState]]:
    cd = cfg.compute_dtype
    S = x.shape[1]
    rec = x @ p["w_in_rec"].to(cd)
    gate = cm.gelu(x @ p["w_in_gate"].to(cd))

    # temporal conv (depthwise, width W) with optional carried tail
    W = p["conv_w"].shape[0]
    if state is not None:
        rec_ext = torch.cat([state.conv.to(cd), rec], dim=1)
    else:
        rec_ext = torch.nn.functional.pad(rec, (0, 0, W - 1, 0))
    conv = rec_ext[:, 0:S, :] * p["conv_w"][0].to(cd)
    for k in range(1, W):
        conv32 = conv.float() + (rec_ext[:, k:k + S, :] * p["conv_w"][k].to(cd)).float()
        conv = conv32.to(cd)
    new_tail = rec_ext[:, rec_ext.shape[1] - (W - 1):, :]

    h, h_last = _rglru_scan(p, conv, state.h if state is not None else None,
                            conv32 if W > 1 else None)
    out = (h * gate) @ p["w_out"].to(cd)
    new_state = RGLRUState(h=h_last, conv=new_tail.to(cd)) if state is not None else None
    return out, new_state


def init_rglru_state(cfg: ArchConfig, batch: int, device, conv_width: int = 4) -> RGLRUState:
    dr = cfg.d_rnn or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, dr), dtype=cfg.compute_dtype, device=device),
        conv=torch.zeros((batch, conv_width - 1, dr), dtype=cfg.compute_dtype, device=device),
    )

