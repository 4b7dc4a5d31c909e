"""GQA attention with the assigned archs' full option surface: a port of
``repro.models.attention``.

Options: grouped KV heads, QKV bias (qwen2.5 / qwen1.5 / qwen2-vl), qk-norm
(qwen3), attention logit softcapping (gemma2), sliding-window "local" layers
(gemma2), M-RoPE (qwen2-vl), cross-attention (whisper), and a KV cache for
decode.

Long sequences use a blockwise streaming softmax over KV chunks of
``BLOCK_KV``: the (Sq, Sk) score matrix never materializes. The attention
is the reference's own einsum-and-softmax code, in the reference's
precision: the score einsums take bfloat16 operands and accumulate and
return float32 (``preferred_element_type``), and the probabilities are
cast to the value dtype before the value einsum.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import common as cm
from repro_torch.models import regions
from repro_torch.models.common import ArchConfig, Params

BLOCK_Q = 512
BLOCK_KV = 1024
NEG_INF = -2.0e38
INT32_MAX = 2**31 - 1


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, H_kv, D)
    v: torch.Tensor  # (B, S_cache, H_kv, D)
    pos: torch.Tensor  # (S_cache,) absolute positions of cached entries

    @staticmethod
    def zeros(cfg: ArchConfig, batch: int, s_cache: int, device) -> "KVCache":
        """An empty cache. As in the reference, ``pos`` starts as
        ``arange(s_cache)``: a slot not yet written reads as that position
        and passes the causal mask."""
        shp = (batch, s_cache, cfg.n_kv_heads, cfg.d_head)
        return KVCache(
            torch.zeros(shp, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shp, dtype=cfg.compute_dtype, device=device),
            torch.arange(s_cache, dtype=torch.int32, device=device),
        )


def init_attn_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dt = cfg.param_dtype
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p: Params = {
        "wq": cm.dense_init(gen, d, h * dh, dt),
        "wk": cm.dense_init(gen, d, hk * dh, dt),
        "wv": cm.dense_init(gen, d, hk * dh, dt),
        "wo": cm.dense_init(gen, h * dh, d, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = cm.zeros(gen, (h * dh,), dt)
        p["bk"] = cm.zeros(gen, (hk * dh,), dt)
        p["bv"] = cm.zeros(gen, (hk * dh,), dt)
    if cfg.qk_norm:
        p["q_norm"] = cm.zeros(gen, (dh,), dt)
        p["k_norm"] = cm.zeros(gen, (dh,), dt)
    return p


def _project(p: Params, cfg: ArchConfig, x: torch.Tensor, xk: Optional[torch.Tensor] = None):
    """The q / k / v projections with their biases, heads still flat:
    q (B, S, H*D), k / v (B, Sk, Hk*D). ``xk`` is the cross-attn source."""
    cd = cfg.compute_dtype
    src = x if xk is None else xk
    q = x @ p["wq"].to(cd)
    k = src @ p["wk"].to(cd)
    v = src @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def _split_heads(p: Params, cfg: ArchConfig, q, k, v):
    """(B, S, h*D) -> (B, S, h, D), qk-normed; ``h`` is what the tensor
    holds (all heads, or a rank's share in a local region)."""
    q = q.reshape(*q.shape[:2], -1, cfg.d_head)
    k = k.reshape(*k.shape[:2], -1, cfg.d_head)
    v = v.reshape(*v.shape[:2], -1, cfg.d_head)
    if cfg.qk_norm:
        q = cm.rms_norm(p["q_norm"], q)
        k = cm.rms_norm(p["k_norm"], k)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Each KV head repeated for its query group (``jnp.repeat``: head j
    serves query heads j*G .. j*G + G - 1)."""
    hk = k.shape[-2]
    if hk == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hk, dim=-2)


def _mask_bias(
    q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: Optional[int]
) -> torch.Tensor:
    """(Sq, Sk) additive float32 mask."""
    d = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF)


def _scaled(q: torch.Tensor) -> torch.Tensor:
    """``q * (1 / sqrt(D))`` with the factor rounded to q's dtype first, as
    a JAX weakly typed scalar is."""
    return q * cm.scalar(1.0 / (q.shape[-1] ** 0.5), q.dtype)


def _scores(spec: str, a: torch.Tensor, b: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A score einsum accumulated and returned in float32, softcapped."""
    return cm.softcap(torch.einsum(spec, a.float(), b.float()), cfg.attn_softcap)


def _pad_kv(k, v, k_pos, axis):
    """K / V padded to whole ``BLOCK_KV`` blocks along ``axis``, the pad
    positions int32 max (masked by causality)."""
    pad = -k.shape[axis] % BLOCK_KV
    if pad:
        shp = list(k.shape)
        shp[axis] = pad
        z = torch.zeros(shp, dtype=k.dtype, device=k.device)
        k = torch.cat([k, z], dim=axis)
        v = torch.cat([v, z.to(v.dtype)], dim=axis)
        k_pos = torch.cat([k_pos, torch.full((pad,), INT32_MAX, dtype=k_pos.dtype,
                                             device=k_pos.device)])
    return k, v, k_pos


def _online_softmax(score_spec, value_spec, qs, k_blocks, v_blocks, kp_blocks,
                    q_pos, causal, window, cfg, stat_shape, acc_shape):
    """The streaming path's loop over KV blocks (online softmax)."""
    dev = qs.device
    acc = torch.zeros(acc_shape, dtype=torch.float32, device=dev)
    m = torch.full(stat_shape, NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(stat_shape, dtype=torch.float32, device=dev)
    for kb, vb, kpb in zip(k_blocks, v_blocks, kp_blocks):
        logits = _scores(score_spec, qs, kb, cfg)
        logits = logits + _mask_bias(q_pos, kpb, causal, window)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(value_spec, p.to(vb.dtype), vb).float()
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _grouped_dense_attention(cfg, q, k, v, q_pos, k_pos, causal, window):
    """GQA without repeat_kv: q grouped as (B, Sq, Hk, G, D); the KV tensors
    keep their native head count."""
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = _scaled(q).reshape(B, Sq, Hk, G, D)
    logits = _scores("bqhgd,bkhd->bhgqk", qg, k, cfg)
    logits = logits + _mask_bias(q_pos, k_pos, causal, window)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, H * D)


def _grouped_streaming_attention(cfg, q, k, v, q_pos, k_pos, causal, window):
    """Blockwise online-softmax attention with native (ungrouped) KV heads."""
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = _scaled(q).reshape(B, Sq, Hk, G, D).permute(0, 2, 3, 1, 4)  # (B, Hk, G, Sq, D)
    kk, vv, kp = _pad_kv(k, v, k_pos, axis=1)
    out = _online_softmax(
        "bhgqd,bkhd->bhgqk", "bhgqk,bkhd->bhgqd", qg,
        kk.split(BLOCK_KV, dim=1), vv.split(BLOCK_KV, dim=1), kp.split(BLOCK_KV),
        q_pos, causal, window, cfg, (B, Hk, G, Sq), (B, Hk, G, Sq, D),
    ).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H * D)


def dot_attention(
    cfg: ArchConfig,
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hk, D)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Dense attention for small ``Sq * Sk``, blockwise streaming softmax
    (never materializes Sq x Sk) above it."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dense = Sq * Sk <= BLOCK_Q * BLOCK_KV * 4

    if cfg.gqa_grouped and k.shape[2] != H:
        path = _grouped_dense_attention if dense else _grouped_streaming_attention
        return path(cfg, q, k, v, q_pos, k_pos, causal, window)

    k = _repeat_kv(k, H).transpose(1, 2)  # (B, H, Sk, D)
    v = _repeat_kv(v, H).transpose(1, 2)
    qs = _scaled(q).transpose(1, 2)  # (B, H, Sq, D)

    if dense:
        logits = _scores("bhqd,bhkd->bhqk", qs, k, cfg)
        logits = logits + _mask_bias(q_pos, k_pos, causal, window)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", w, v)
        return out.transpose(1, 2).reshape(B, Sq, H * D)

    k, v, k_pos = _pad_kv(k, v, k_pos, axis=2)
    out = _online_softmax(
        "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd", qs,
        k.split(BLOCK_KV, dim=2), v.split(BLOCK_KV, dim=2), k_pos.split(BLOCK_KV),
        q_pos, causal, window, cfg, (B, H, Sq), (B, H, Sq, D),
    ).to(q.dtype)
    return out.transpose(1, 2).reshape(B, Sq, H * D)


def attend(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    pos: torch.Tensor,  # (B, S) int positions (or pos3 (3,B,S) for mrope)
    kind: str,  # "global" | "local"
    causal: bool = True,
    cache: Optional[KVCache] = None,
    cache_at=None,  # write offset: an int, or for decode a 0-d int32 on the device
    xk: Optional[torch.Tensor] = None,  # cross-attention source (pre-projected x)
    rope: bool = True,
):
    """Full attention op. Returns (out (B,S,d_model), updated cache).

    Under a mesh (DTensor inputs) the projections are DTensor ops, and the
    attention core between them is a local region (``models.regions``):
    batch over the DP axes, heads over "model" where ``n_kv_heads`` divides
    by its size (whole heads, the query heads of a KV head on its rank),
    else replicated. A sequence-sharded cache is redistributed to the same
    placements, written and attended locally, and handed back in the
    placements it came in."""
    q, k, v = _project(p, cfg, x, xk)
    mesh = regions.mesh_of(q, k, v, cache.k if cache is not None else None)
    if mesh is None:
        out, new_cache = _attend_local(p, cfg, q, k, v, pos, kind, causal, cache, cache_at,
                                       xk is not None, rope)
        return out @ p["wo"].to(cfg.compute_dtype), new_cache

    # batch dim 0, heads dim 2: of q / k / v (B, S, h*D) and of a cache (B, S, h, D)
    B = q.shape[0]
    where = regions.placements(mesh, B, 0, cfg.n_kv_heads, 2)
    rep = regions.replicated(mesh)
    q, k, v = (regions.local(t, mesh, where) for t in (q, k, v))
    pos = regions.local(pos, mesh, regions.placements(mesh, B, pos.ndim - 2))
    if cache is not None:
        held = [getattr(t, "placements", rep) for t in cache]
        cache = KVCache(regions.local(cache.k, mesh, where), regions.local(cache.v, mesh, where),
                        regions.local(cache.pos, mesh, rep))
    norms = {k: regions.param(p[k], mesh, where) for k in ("q_norm", "k_norm") if k in p}
    out, new_cache = _attend_local(norms, cfg, q, k, v, pos, kind, causal, cache, cache_at,
                                   xk is not None, rope)
    out = regions.wrap(out, mesh, where)
    if new_cache is not None:  # back in the placements the cache came in
        new_cache = KVCache(*(regions.wrap(t, mesh, w).redistribute(mesh, back)
                              for t, w, back in zip(new_cache, (where, where, rep), held)))
    return out @ p["wo"].to(cfg.compute_dtype), new_cache


def _attend_local(p, cfg, q, k, v, pos, kind, causal, cache, cache_at, cross, rope):
    """The attention core on plain tensors: q / k / v with flat heads,
    positions, the cache, and ``p``'s qk-norm scales; returns (out (B, S,
    h*D), new cache)."""
    q, k, v = _split_heads(p, cfg, q, k, v)
    S = q.shape[1]

    if rope and not cross:
        if cfg.mrope_sections is not None:
            q = cm.apply_mrope(q, pos, cfg.rope_theta, cfg.mrope_sections)
            k = cm.apply_mrope(k, pos, cfg.rope_theta, cfg.mrope_sections)
            q_pos1 = pos[0, 0]  # temporal track for masking
        else:
            q = cm.apply_rope(q, pos, cfg.rope_theta)
            k = cm.apply_rope(k, pos, cfg.rope_theta)
            q_pos1 = pos[0]
    else:
        q_pos1 = pos[0] if pos.ndim == 2 else pos[0, 0]

    window = cfg.window if kind == "local" else None

    if cache is not None:
        S_cache = cache.k.shape[1]
        if S > S_cache:
            # prefill longer than a windowed ring: attend directly over the
            # in-sequence K/V (window mask bounds the reach), then store only
            # the last S_cache entries, slot-aligned so slot == pos % S_cache.
            # Prefill only: the start is read on the host.
            at = int(cache_at)
            kp = pos[0] if pos.ndim == 2 else pos[0, 0]
            out = dot_attention(cfg, q, k, v, q_pos1, kp, causal, window)
            tail_k = k[:, -S_cache:].to(cache.k.dtype)
            tail_v = v[:, -S_cache:].to(cache.v.dtype)
            tail_pos = (at + S - S_cache) + torch.arange(S_cache, dtype=torch.int32,
                                                         device=q.device)
            shift = (at + S - S_cache) % S_cache
            new_cache = KVCache(
                torch.roll(tail_k, shift, dims=1),
                torch.roll(tail_v, shift, dims=1),
                torch.roll(tail_pos, shift, dims=0),
            )
        else:
            # decode / short prefill: write at cache_at (mod ring size), then
            # attend over the whole cache; positional masking does the rest.
            # The start is clamped so the update fits, as
            # lax.dynamic_update_slice clamps it, and stays on the device: a
            # 0-d int32 position is never read on the host.
            at = cm.position(cache_at, q.device)
            rows = torch.arange(S, dtype=torch.int32, device=q.device)
            idx = (torch.clamp(at % S_cache, max=S_cache - S) + rows).long()
            k_all = cache.k.clone()
            v_all = cache.v.clone()
            pos_new = cache.pos.clone()
            k_all.index_copy_(1, idx, k.to(cache.k.dtype))
            v_all.index_copy_(1, idx, v.to(cache.v.dtype))
            pos_new.index_copy_(0, idx, at + rows)
            out = dot_attention(cfg, q, k_all, v_all, q_pos1, pos_new, causal, window)
            new_cache = KVCache(k_all, v_all, pos_new)
    else:
        k_pos = pos[0] if pos.ndim == 2 else pos[0, 0]
        if cross:
            k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
        out = dot_attention(cfg, q, k, v, q_pos1, k_pos, causal, window)
        new_cache = None
    return out, new_cache
