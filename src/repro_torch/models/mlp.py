"""Feed-forward layers: SwiGLU / GeGLU / plain GELU. A port of
``repro.models.mlp``; ``jax.nn.gelu`` is the tanh approximation, and so is
the GELU here. SiLU and GELU run as the reference's steps
(``common.silu`` / ``common.gelu``), each rounded to the compute dtype as
XLA rounds it."""

from __future__ import annotations

import torch

from repro_torch.models import common as cm
from repro_torch.models import regions
from repro_torch.models.common import ArchConfig, Params


gelu = cm.gelu


def init_mlp_params(gen: torch.Generator, cfg: ArchConfig, d_ff: int | None = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": cm.dense_init(gen, cfg.d_model, d_ff, dt),
            "w_up": cm.dense_init(gen, cfg.d_model, d_ff, dt),
            "w_down": cm.dense_init(gen, d_ff, cfg.d_model, dt),
        }
    return {
        "w_up": cm.dense_init(gen, cfg.d_model, d_ff, dt),
        "b_up": cm.zeros(gen, (d_ff,), dt),
        "w_down": cm.dense_init(gen, d_ff, cfg.d_model, dt),
        "b_down": cm.zeros(gen, (cfg.d_model,), dt),
    }


def mlp(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.compute_dtype
    if cfg.act in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(cd)
        u = x @ p["w_up"].to(cd)
        act = cm.silu(g) if cfg.act == "swiglu" else cm.gelu(g)
        return regions.constrain(act * u, 0, -1) @ p["w_down"].to(cd)
    h = x @ p["w_up"].to(cd) + p["b_up"].to(cd)
    h = cm.gelu(h)
    return regions.constrain(h, 0, -1) @ p["w_down"].to(cd) + p["b_down"].to(cd)
