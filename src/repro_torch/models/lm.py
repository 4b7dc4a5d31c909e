"""Top-level models: decoder-only LM, encoder-decoder (whisper), VLM
backbone. A port of ``repro.models.lm``.

Public entry points (plain functions of (cfg, params, ...) on the params'
device):

  * ``init_params``            — full parameter tree, on the card by default
                                 (``device="meta"``: shapes and dtypes only)
  * ``forward``                — training forward -> logits (B, S, V)
  * ``loss_fn``                — next-token cross-entropy
  * ``init_cache`` / ``prefill`` / ``decode_step``

Modality frontends are stubs as in the reference: whisper takes
precomputed frame embeddings (B, enc_seq, d_model); qwen2-vl takes token
ids plus M-RoPE position ids (3, B, S).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.engine import _resolve_device
from repro_torch.models import blocks
from repro_torch.models import common as cm
from repro_torch.models import regions
from repro_torch.models.common import ArchConfig, Params


def _generator(seed_or_generator: Union[int, torch.Generator], device):
    """A seed as a ``torch.Generator`` on ``device`` (``None`` on ``meta``,
    where the initializers draw nothing); a generator as is."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    dev = _resolve_device(device)
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(int(seed_or_generator))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(
    cfg: ArchConfig, seed_or_generator: Union[int, torch.Generator], device="cuda"
) -> Params:
    """Random parameters, drawn on the generator's device (a seed gives a
    generator on ``device``). The tree is the reference's, key for key."""
    gen = _generator(seed_or_generator, device)
    p: Params = {
        "embed": cm.embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype),
        "stack": blocks.init_stacked_params(gen, cfg),
        "ln_f": cm.zeros(gen, (cfg.d_model,), cfg.param_dtype),
    }
    if not cfg.tie_embeddings:
        p["head"] = cm.dense_init(gen, cfg.d_model, cfg.vocab, cfg.param_dtype)
    if cfg.enc_layers > 0:
        p["enc_stack"] = blocks.init_stacked_params(gen, _encoder_cfg(cfg))
        p["enc_ln_f"] = cm.zeros(gen, (cfg.d_model,), cfg.param_dtype)
        p["enc_pos"] = cm.normal(gen, (cfg.enc_seq, cfg.d_model), 0.01, cfg.param_dtype)
    return p


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(
        cfg,
        n_layers=cfg.enc_layers,
        pattern=("global",),
        cross_attention=False,
        moe=None,
    )


# ---------------------------------------------------------------------------
# shared trunk
# ---------------------------------------------------------------------------


def _embed(cfg: ArchConfig, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings. Under a mesh the lookup is a local region
    (each rank's tokens into the whole table, its gradient partial over the
    DP axes): the same gather and scatter-add as on one device, where
    DTensor's own ``index_put`` strategy for the backward fails."""
    table = p["embed"]
    mesh = regions.mesh_of(table, tokens)
    if mesh is None:
        x = table[tokens.long()]
    else:
        where = regions.placements(mesh, tokens.shape[0], 0)
        rows = regions.param(table, mesh, where)[regions.local(tokens, mesh, where).long()]
        x = regions.constrain(regions.wrap(rows, mesh, where))
    x = x.to(cfg.compute_dtype)
    if cfg.tie_embeddings:  # gemma-style scaled embeddings, the scale in compute dtype
        x = x * cm.scalar(cfg.d_model**0.5, cfg.compute_dtype)
    return x


def _head(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The logits. Under a mesh they are pinned batch over the DP axes and
    vocab over "model" right at the matmul, so that its backward gets the
    gradient in the matmul's own layout: left to itself, DTensor lays the
    softcap's and the loss's gradient out with the sequence over "model",
    and the weight gradient's contraction over the flattened tokens then
    meets a strided split it has no strategy for (gemma2-9b on the
    (2, 16, 16) mesh)."""
    x = cm.rms_norm(p["ln_f"], regions.constrain(x))
    if cfg.tie_embeddings:
        logits = x @ p["embed"].to(cfg.compute_dtype).T
    else:
        logits = x @ p["head"].to(cfg.compute_dtype)
    return cm.softcap(regions.constrain(logits, model_dim=-1).float(), cfg.logit_softcap)


def _encode(cfg: ArchConfig, p: Params, enc_embeds: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over precomputed (stub) frame embeddings."""
    enc_cfg = _encoder_cfg(cfg)
    x = enc_embeds.to(cfg.compute_dtype) + p["enc_pos"][None].to(cfg.compute_dtype)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None].expand(x.shape[:2])
    x, _, _ = blocks.apply_stack(p["enc_stack"], enc_cfg, x, pos, causal=False)
    return cm.rms_norm(p["enc_ln_f"], x)


def _positions(cfg: ArchConfig, batch: int, seq: int, device, pos3=None):
    base = torch.arange(seq, dtype=torch.int32, device=device)[None].expand(batch, seq)
    if cfg.mrope_sections is not None:
        return base[None].expand(3, batch, seq) if pos3 is None else pos3
    return base


# ---------------------------------------------------------------------------
# training forward + loss
# ---------------------------------------------------------------------------


def forward(
    cfg: ArchConfig,
    p: Params,
    tokens: torch.Tensor,  # (B, S)
    pos3: Optional[torch.Tensor] = None,  # (3, B, S) for M-RoPE archs
    enc_embeds: Optional[torch.Tensor] = None,  # (B, enc_seq, d) whisper stub
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    B, S = tokens.shape
    x = _embed(cfg, p, tokens)
    pos = _positions(cfg, B, S, x.device, pos3)
    enc_out = _encode(cfg, p, enc_embeds) if cfg.enc_layers > 0 else None
    x, _, aux = blocks.apply_stack(p["stack"], cfg, x, pos, enc_out=enc_out)
    return _head(cfg, p, x), aux


def loss_fn(
    cfg: ArchConfig,
    p: Params,
    batch: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token cross-entropy over the labels >= 0. As
    ``jnp.take_along_axis`` does, a label of -1 reads the last vocab entry
    (the mask then zeroes it); ``torch.gather`` would refuse it."""
    logits, aux = forward(cfg, p, batch["tokens"], batch.get("pos3"), batch.get("enc_embeds"))
    labels = batch["labels"].long()
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    if cfg.sharded_xent:
        # the reference's vocab-shard-aware form: logsumexp and the label
        # logit, both reductions over the vocab axis (one device here: the
        # one-hot contraction is the gathered logit, exactly)
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
        ll = label_logit - lse
    else:
        logp = torch.log_softmax(logits, dim=-1)
        idx = torch.where(labels < 0, labels + logits.shape[-1], labels)
        ll = torch.gather(logp, -1, idx[..., None])[..., 0]
    loss = -torch.sum(ll * mask) / denom
    aux["loss"] = loss
    return loss, aux


# ---------------------------------------------------------------------------
# inference: cache init, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, s_cache: int, device="cuda"):
    return blocks.init_stacked_cache(cfg, batch, s_cache, _resolve_device(device))


def prefill(
    cfg: ArchConfig,
    p: Params,
    tokens: torch.Tensor,  # (B, S)
    caches,
    pos3: Optional[torch.Tensor] = None,
    enc_embeds: Optional[torch.Tensor] = None,
):
    """Populate caches for the prompt; returns (last-token logits, caches)."""
    B, S = tokens.shape
    x = _embed(cfg, p, tokens)
    pos = _positions(cfg, B, S, x.device, pos3)
    enc_out = _encode(cfg, p, enc_embeds) if cfg.enc_layers > 0 else None
    x, caches, _ = blocks.apply_stack(
        p["stack"], cfg, x, pos, caches=caches, cache_at=0, enc_out=enc_out,
    )
    return _head(cfg, p, x[:, -1:, :]), caches


def decode_step(
    cfg: ArchConfig,
    p: Params,
    token: torch.Tensor,  # (B, 1)
    index: Union[int, torch.Tensor],  # current absolute position: an int or a 0-d int32
    caches,
    pos3: Optional[torch.Tensor] = None,  # (3, B, 1)
    enc_embeds: Optional[torch.Tensor] = None,
):
    """One serving step: append one token, return (logits (B,1,V), caches).

    ``index`` may be a 0-d int32 tensor on the device, as the reference's
    ``index: jax.Array``: then nothing reads it on the host (a CUDA graph
    of the step replays any position). An int is made one on the device."""
    B = token.shape[0]
    x = _embed(cfg, p, token)
    index = cm.position(index, x.device)
    pos = index.reshape(1, 1).expand(B, 1)
    if cfg.mrope_sections is not None:
        pos = pos3 if pos3 is not None else pos[None].expand(3, B, 1)
    enc_out = _encode(cfg, p, enc_embeds) if cfg.enc_layers > 0 else None
    x, caches, _ = blocks.apply_stack(
        p["stack"], cfg, x, pos, caches=caches, cache_at=index, enc_out=enc_out
    )
    return _head(cfg, p, x), caches
