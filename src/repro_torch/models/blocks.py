"""Decoder block assembly and the grouped stack: a port of
``repro.models.blocks``.

A *group* is one repetition of the arch's layer pattern (e.g. gemma2 =
("local", "global")). Parameters and caches carry a leading ``n_groups``
axis, as in the reference; the stack loops over the groups in Python where
the reference scans. This package has the attention kinds ``global`` and
``local`` (with cross-attention and post-norm); the recurrent (RG-LRU) and
SSD kinds are not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.models import attention, mlp, moe
from repro_torch.models import common as cm
from repro_torch.models.common import ArchConfig, Params

ATTENTION_KINDS = ("global", "local")


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} (RG-LRU / SSD) is not ported to PyTorch yet "
        "(ROADMAP A 14: models/rglru.py and models/ssd.py)"
    )


def _check_kind(kind: str) -> None:
    if kind in ("recurrent", "ssd"):
        raise _unported(kind)
    if kind not in ATTENTION_KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# per-position (within group) param/cache builders
# ---------------------------------------------------------------------------


def init_block_params(gen: torch.Generator, cfg: ArchConfig, kind: str) -> Params:
    _check_kind(kind)
    dt = cfg.param_dtype
    p: Params = {"ln1": cm.zeros(gen, (cfg.d_model,), dt)}
    p["mixer"] = attention.init_attn_params(gen, cfg)

    if cfg.cross_attention:
        p["ln_x"] = cm.zeros(gen, (cfg.d_model,), dt)
        p["xattn"] = attention.init_attn_params(gen, cfg)

    if cfg.moe is not None:
        p["ln2"] = cm.zeros(gen, (cfg.d_model,), dt)
        p["ffn"] = moe.init_moe_params(gen, cfg)
    elif cfg.d_ff > 0:
        p["ln2"] = cm.zeros(gen, (cfg.d_model,), dt)
        p["ffn"] = mlp.init_mlp_params(gen, cfg)
    if cfg.post_norm:
        p["ln1b"] = cm.zeros(gen, (cfg.d_model,), dt)
        if "ln2" in p:
            p["ln2b"] = cm.zeros(gen, (cfg.d_model,), dt)
    return p


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, s_cache: int, device) -> Any:
    _check_kind(kind)
    size = s_cache if kind == "global" else min(s_cache, cfg.window or s_cache)
    return attention.KVCache.zeros(cfg, batch, size, device)


def apply_block(
    p: Params,
    cfg: ArchConfig,
    kind: str,
    x: torch.Tensor,
    pos: torch.Tensor,
    cache: Any = None,
    cache_at: Optional[int] = None,
    enc_out: Optional[torch.Tensor] = None,
    aux: Optional[dict] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Any]:
    _check_kind(kind)
    h = cm.rms_norm(p["ln1"], x)
    out, new_cache = attention.attend(
        p["mixer"], cfg, h, pos, kind, causal=causal, cache=cache, cache_at=cache_at,
    )
    if cfg.post_norm:
        out = cm.rms_norm(p["ln1b"], out)
    x = x + out

    if cfg.cross_attention and enc_out is not None:
        hx = cm.rms_norm(p["ln_x"], x)
        xo, _ = attention.attend(
            p["xattn"], cfg, hx, pos, "global", causal=False, xk=enc_out, rope=False,
        )
        x = x + xo

    if "ffn" in p:
        h2 = cm.rms_norm(p["ln2"], x)
        if cfg.moe is not None:
            f, moe_aux = moe.moe_ffn(p["ffn"], cfg, h2)
            if aux is not None:
                aux.update(moe_aux)
        else:
            f = mlp.mlp(p["ffn"], cfg, h2)
        if cfg.post_norm:
            f = cm.rms_norm(p["ln2b"], f)
        x = x + f
    return x, new_cache


# ---------------------------------------------------------------------------
# group = one repetition of the pattern; stack = a loop over groups
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    """``fn`` over the leaves (tensors) of nested dicts and NamedTuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and NamedTuples, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def init_group_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {f"b{i}": init_block_params(gen, cfg, kind) for i, kind in enumerate(cfg.pattern)}


def init_stacked_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Params with a leading n_groups axis on every leaf."""
    per_group = [init_group_params(gen, cfg) for _ in range(cfg.n_groups)]
    return tree_map(lambda *xs: torch.stack(xs), *per_group)


def init_stacked_cache(cfg: ArchConfig, batch: int, s_cache: int, device):
    one = {
        f"b{i}": init_block_cache(cfg, kind, batch, s_cache, device)
        for i, kind in enumerate(cfg.pattern)
    }
    return tree_map(lambda x: x[None].expand(cfg.n_groups, *x.shape).clone(), one)


def apply_stack(
    params_stacked: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    pos: torch.Tensor,
    caches=None,
    cache_at: Optional[int] = None,
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
):
    """Apply the grouped decoder stack. Returns (x, new_caches, aux)."""
    dropped = torch.zeros((), dtype=torch.int32, device=x.device)
    new_caches = []
    for g in range(cfg.n_groups):
        gp = tree_map(lambda a: a[g], params_stacked)
        gc = tree_map(lambda a: a[g], caches) if caches is not None else None
        new_gc = {}
        aux_local: dict = {}
        for i, kind in enumerate(cfg.pattern):
            x, upd = apply_block(
                gp[f"b{i}"], cfg, kind, x, pos,
                cache=gc[f"b{i}"] if gc is not None else None, cache_at=cache_at,
                enc_out=enc_out, aux=aux_local, causal=causal,
            )
            new_gc[f"b{i}"] = upd
        if "moe_dropped_slots" in aux_local:
            dropped = dropped + aux_local["moe_dropped_slots"]
        new_caches.append(new_gc)
    aux = {"moe_dropped_slots": dropped}
    if caches is None:
        return x, None, aux
    return x, tree_map(lambda *xs: torch.stack(xs), *new_caches), aux
