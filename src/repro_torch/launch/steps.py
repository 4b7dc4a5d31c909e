"""Step builders + abstract input specs for every (arch x shape) cell: a port
of ``repro.launch.steps``.

``abstract_inputs(cfg, shape)`` returns stand-ins for everything a cell's
step consumes (params, optimizer state, batches, KV caches) as tensors on
``torch.device("meta")``: shapes and dtypes, no memory, the counterpart of
the reference's ``jax.eval_shape`` trees.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get, get_smoke
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.models import lm
from repro_torch.models.blocks import tree_map
from repro_torch.models.common import ArchConfig
from repro_torch.train import optimizer as opt

DEFAULT_OPT = opt.OptConfig()
META = torch.device("meta")


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, ocfg: opt.OptConfig = DEFAULT_OPT):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient, then AdamW written into
    ``params`` and ``opt_state`` in place (the reference's jit donates
    those buffers). ``metrics`` holds ``loss``, ``grad_norm``, ``lr`` and
    ``moe_dropped_slots`` (tensors on the device).

    Every step runs under ``implicit_replication``: with DTensor
    parameters (a mesh), a plain tensor the model makes (positions, masks,
    RoPE tables) counts as replicated; with plain parameters it does
    nothing."""

    def _cast_once(p):
        if not cfg.cast_params_once:
            return p
        return tree_map(
            lambda x: x.to(cfg.compute_dtype)
            if (x.dtype == torch.float32 and x.ndim >= 2) else x,
            p,
        )

    def train_step(params, opt_state, batch):
        with torch.enable_grad(), implicit_replication():
            p = tree_map(lambda x: x.detach().requires_grad_(True), params)
            loss, aux = lm.loss_fn(cfg, _cast_once(p), batch)
            leaves = opt.sorted_leaves(p)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            by_leaf = {id(x): torch.zeros_like(x) if g is None else g
                       for x, g in zip(leaves, grads)}
            grads = tree_map(lambda x: by_leaf[id(x)], p)
            new_params, new_state, stats = opt.adamw_update_(ocfg, params, grads, opt_state)
        metrics = {"loss": loss.detach(), **stats}
        if "moe_dropped_slots" in aux:
            metrics["moe_dropped_slots"] = aux["moe_dropped_slots"]
        return new_params, new_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, tokens, caches, extras):
        with implicit_replication():
            return lm.prefill(
                cfg, params, tokens, caches, extras.get("pos3"), extras.get("enc_embeds"),
            )

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, token, index, caches, extras):
        with implicit_replication():
            return lm.decode_step(
                cfg, params, token, index, caches, extras.get("pos3"), extras.get("enc_embeds"),
            )

    return serve_step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def abstract_params(cfg: ArchConfig):
    return lm.init_params(cfg, 0, META)


def abstract_opt_state(cfg: ArchConfig, ocfg: opt.OptConfig = DEFAULT_OPT):
    return opt.init_opt_state(ocfg, abstract_params(cfg))


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _extras(cfg: ArchConfig, B: int, S: int) -> Dict[str, Any]:
    ex: Dict[str, Any] = {}
    if cfg.enc_layers > 0:
        ex["enc_embeds"] = _sds((B, cfg.enc_seq, cfg.d_model), torch.float32)
    if cfg.mrope_sections is not None:
        ex["pos3"] = _sds((3, B, S), torch.int32)
    return ex


def abstract_inputs(
    cfg: ArchConfig, shape: ShapeSpec, ocfg: opt.OptConfig = DEFAULT_OPT
) -> Tuple[Any, ...]:
    """Abstract step arguments for this cell (matching the step builder)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {
            "tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32),
            **_extras(cfg, B, S),
        }
        return (abstract_params(cfg), abstract_opt_state(cfg, ocfg), batch)
    if shape.kind == "prefill":
        caches = lm.init_cache(cfg, B, S, META)
        return (abstract_params(cfg), _sds((B, S), torch.int32), caches, _extras(cfg, B, S))
    if shape.kind == "decode":
        caches = lm.init_cache(cfg, B, S, META)
        return (
            abstract_params(cfg),
            _sds((B, 1), torch.int32),
            _sds((), torch.int32),
            caches,
            _extras(cfg, B, 1),
        )
    raise ValueError(shape.kind)


def build_cell(arch: str, shape_name: str, smoke: bool = False):
    """Returns (cfg, shape, step_fn, abstract_args)."""
    cfg = get_smoke(arch) if smoke else get(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        step = make_train_step(cfg)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)
    else:
        step = make_serve_step(cfg)
    return cfg, shape, step, abstract_inputs(cfg, shape)
