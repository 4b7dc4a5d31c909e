"""Decoder block assembly and the grouped stack: a port of
``repro.models.blocks``.

A *group* is one repetition of the arch's layer pattern (e.g. gemma2 =
("local", "global"), recurrentgemma = ("recurrent", "recurrent", "local"),
mamba2 = ("ssd",)). Parameters and caches carry a leading ``n_groups``
axis, as in the reference; the stack loops over the groups in Python where
the reference scans, each stacked leaf split into its groups by one
``unbind`` (whose backward is one ``stack``). Under ``cfg.remat == "block"``
with grad enabled each group runs under ``torch.utils.checkpoint``, as the
reference's scanned body runs under ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, mlp, moe, rglru, ssd
from repro_torch.models import common as cm
from repro_torch.models import regions
from repro_torch.models.common import ArchConfig, Params

ATTENTION_KINDS = ("global", "local")
KINDS = ATTENTION_KINDS + ("recurrent", "ssd")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# per-position (within group) param/cache builders
# ---------------------------------------------------------------------------


def init_block_params(gen: torch.Generator, cfg: ArchConfig, kind: str) -> Params:
    _check_kind(kind)
    dt = cfg.param_dtype
    p: Params = {"ln1": cm.zeros(gen, (cfg.d_model,), dt)}
    if kind in ATTENTION_KINDS:
        p["mixer"] = attention.init_attn_params(gen, cfg)
    elif kind == "recurrent":
        p["mixer"] = rglru.init_rglru_params(gen, cfg)
    else:
        p["mixer"] = ssd.init_ssd_params(gen, cfg)

    if cfg.cross_attention and kind in ATTENTION_KINDS:
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
    if kind == "recurrent":
        return rglru.init_rglru_state(cfg, batch, device)
    if kind == "ssd":
        return ssd.init_ssd_state(cfg, batch, device)
    size = s_cache if kind == "global" else min(s_cache, cfg.window or s_cache)
    return attention.KVCache.zeros(cfg, batch, size, device)


def apply_block(
    p: Params,
    cfg: ArchConfig,
    kind: str,
    x: torch.Tensor,
    pos: torch.Tensor,
    cache: Any = None,
    cache_at=None,  # an int, or a 0-d int32 on the device (decode)
    enc_out: Optional[torch.Tensor] = None,
    aux: Optional[dict] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Any]:
    x, _, new_cache = _block(p, cfg, kind, x, None, pos, cache, cache_at, enc_out, aux, causal)
    return x, new_cache


def _block(p, cfg, kind, x, xs, pos, cache, cache_at, enc_out, aux, causal):
    """One block; ``xs`` is ``x`` before its rounding to the compute dtype
    (float32; ``None``: ``x`` as it is). Every norm of a residual sum reads
    that float32 sum, as the reference's XLA program does (it drops the
    round trip between the add and the norm's float32 cast inside a group).
    Returns (x, xs, new_cache)."""
    _check_kind(kind)
    x = regions.constrain(x)  # a group's (or the encoder's) input; xs is pinned below
    h = cm.rms_norm(p["ln1"], x if xs is None else xs, dtype=x.dtype)
    if kind in ATTENTION_KINDS:
        out, new_cache = attention.attend(
            p["mixer"], cfg, h, pos, kind, causal=causal, cache=cache, cache_at=cache_at,
        )
    elif kind == "recurrent":
        out, new_cache = regions.batch_local(rglru.rglru_block, p["mixer"], cfg, h, cache)
    else:
        out, new_cache = regions.batch_local(ssd.ssd_block, p["mixer"], cfg, h, cache)
    if cfg.post_norm:  # pinned first: a norm of the matmul's raw layout (see lm._head)
        out = cm.rms_norm(p["ln1b"], regions.constrain(out))
    xs = regions.constrain(x.float() + regions.constrain(out).float())
    x = xs.to(x.dtype)

    if cfg.cross_attention and enc_out is not None and kind in ATTENTION_KINDS:
        hx = cm.rms_norm(p["ln_x"], xs, dtype=x.dtype)
        xo, _ = attention.attend(
            p["xattn"], cfg, hx, pos, "global", causal=False, xk=enc_out, rope=False,
        )
        xs = regions.constrain(x.float() + regions.constrain(xo).float())
        x = xs.to(x.dtype)

    if "ffn" in p:
        h2 = cm.rms_norm(p["ln2"], xs, dtype=x.dtype)
        if cfg.moe is not None:
            f, moe_aux = moe.moe_ffn(p["ffn"], cfg, h2)
            if aux is not None:
                aux.update(moe_aux)
        else:
            f = mlp.mlp(p["ffn"], cfg, h2)
        if cfg.post_norm:
            f = cm.rms_norm(p["ln2b"], regions.constrain(f))
        xs = regions.constrain(x.float() + regions.constrain(f).float())
        x = xs.to(x.dtype)
    return x, xs, new_cache


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


def tree_flatten(tree, prefix: str = ""):
    """(paths, leaves) in JAX's ``tree_flatten_with_path`` order (dict keys
    sorted, NamedTuple fields in order, ``None`` no leaf), each path joined
    as the reference's checkpoints join it (``opt/.mu/embed``)."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for name, sub in items:
        k, v = tree_flatten(sub, f"{prefix}/{name}" if prefix else name)
        paths += k
        leaves += v
    return paths, leaves


def sorted_leaves(tree) -> list:
    """The leaves in JAX's flattening order (``tree_flatten``)."""
    return tree_flatten(tree)[1]


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


def unstack(tree, n: int) -> list:
    """A tree whose leaves carry a leading axis of ``n`` as ``n`` trees: one
    ``unbind`` a leaf (a ``select`` a group would add a full-size zero stack
    a group in the backward pass)."""
    parts = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    out = []
    for g in range(n):
        it = iter(p[g] for p in parts)
        out.append(tree_map(lambda _: next(it), tree))
    return out


def apply_stack(
    params_stacked: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    pos: torch.Tensor,
    caches=None,
    cache_at=None,  # an int, or a 0-d int32 on the device (decode)
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
):
    """Apply the grouped decoder stack. Returns (x, new_caches, aux)."""

    def group_apply(xc, gp, gc):
        """One group; returns its MoE dropped slots rather than adding them to
        an outer count, so a recompute under remat counts nothing twice."""
        new_gc = {}
        aux_local: dict = {}
        xs = None  # a group's input is rounded (the scan's carry)
        for i, kind in enumerate(cfg.pattern):
            xc, xs, new_gc[f"b{i}"] = _block(
                gp[f"b{i}"], cfg, kind, xc, xs, pos,
                gc[f"b{i}"] if gc is not None else None, cache_at, enc_out, aux_local, causal,
            )
        dropped = aux_local.get("moe_dropped_slots")
        return xc, dropped, new_gc if gc is not None else None

    remat = cfg.remat == "block" and torch.is_grad_enabled()
    dropped = torch.zeros((), dtype=torch.int32, device=x.device)
    group_params = unstack(params_stacked, cfg.n_groups)
    group_caches = unstack(caches, cfg.n_groups) if caches is not None else [None] * cfg.n_groups
    new_caches = []
    for gp, gc in zip(group_params, group_caches):
        if remat:
            # the group draws no random numbers, so no RNG state to keep for
            # the recompute (reading a CUDA generator's state breaks a capture)
            x, d, new_gc = checkpoint(group_apply, x, gp, gc, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, d, new_gc = group_apply(x, gp, gc)
        if d is not None:
            dropped = dropped + d
        new_caches.append(new_gc)
    aux = {"moe_dropped_slots": dropped}
    if caches is None:
        return x, None, aux
    return x, tree_map(lambda *xs: torch.stack(xs), *new_caches), aux
