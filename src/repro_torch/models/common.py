"""Shared model substrate: configs, norms, RoPE / M-RoPE, initializers.

A port of ``repro.models.common``. Parameters are nested dicts of tensors
(the reference's pytree, key for key); every function is a plain function
of tensors on one device. The stack keeps the reference's layout: every
parameter and cache leaf of the decoder carries a leading ``n_groups`` axis
(a group is one repetition of the arch's layer pattern), and
``blocks.apply_stack`` loops over the groups where the reference scans.

Initializers draw from an explicit ``torch.Generator`` on the target
device; their values are not the reference's (``jax.random``), so the
parity tests carry the reference's parameters across with
``models.bridge.params_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router: str = "topk"  # "topk" (drop overflow) | "laminar" (bounded bounce)
    laminar_bounces: int = 1  # bounded re-addressing rounds for overflow tokens
    laminar_gamma: float = 0.05  # heat-repulsion strength on router logits


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    window: Optional[int] = None  # sliding window for "local" layers
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # layer pattern: one group = this sequence of block kinds, repeated
    # kinds: "global", "local", "recurrent", "ssd", "enc" (handled separately)
    pattern: Tuple[str, ...] = ("global",)

    act: str = "swiglu"  # swiglu | geglu | gelu
    post_norm: bool = False  # gemma2 pre+post norm sandwich
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    d_rnn: Optional[int] = None  # recurrentgemma RG-LRU width

    # encoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0  # precomputed frame embeddings (frontend stub)
    cross_attention: bool = False

    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # none | block: under "block", a stack run with grad enabled recomputes
    # each group's activations in the backward pass
    # (torch.utils.checkpoint, the reference's jax.checkpoint); a run without
    # grad (inference) keeps none to recompute
    remat: str = "block"

    # --- performance knobs, kept so a config means what it means in the
    # reference. The sharding knobs change no value. The port acts on each:
    # sharded_xent in models/lm.py (the loss's logsumexp form),
    # cast_params_once in launch/steps.py (one cast of the parameters a
    # step), zero3_inference, row_parallel and kv_replicated in
    # launch/dryrun.py (a cell's parameter specs, by parallel/sharding.py),
    # and moe_ep_constraint in models/moe.py (expert_parallel: under a mesh,
    # the dispatch buffer and the expert output on "model").
    sharded_xent: bool = False
    cast_params_once: bool = False
    zero3_inference: bool = True
    # MoE dispatch positions by a log-depth scan instead of a cumsum
    moe_assoc_scan: bool = False
    row_parallel: bool = False
    # GQA attention by a grouped einsum instead of repeating K/V heads
    gqa_grouped: bool = False
    kv_replicated: bool = False
    moe_ep_constraint: bool = False

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern {self.pattern}"
        )
        return self.n_layers // len(self.pattern)

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced-config clone for smoke tests."""
        return dataclasses.replace(self, **kw)


def scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python number as a 0-dim CPU tensor of ``dtype``: what a JAX weakly
    typed scalar becomes next to an array of that dtype (``x * 0.0884``
    multiplies a bfloat16 ``x`` by the bfloat16 rounding of 0.0884). A
    0-dim CPU tensor mixes with tensors on any device without a copy."""
    return torch.tensor(value, dtype=dtype)


# ---------------------------------------------------------------------------
# elementwise functions as the reference's XLA program computes them: each
# step of the JAX source is one op in the input's dtype, so in bfloat16 each
# step rounds to bfloat16 as XLA rounds it (a fused PyTorch op computes in
# float32 and rounds once)
# ---------------------------------------------------------------------------


def sigmoid(x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``jax.nn.sigmoid`` (``lax.logistic``): ``1 / (1 + exp(-x))``.
    ``dtype=torch.float32``: the last step unrounded, as XLA leaves it when
    the source casts the sigmoid straight to float32."""
    den = torch.exp(-x) + 1.0
    return torch.reciprocal(den if dtype is None else den.to(dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation):
    ``x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x**3))))``."""
    dt = x.dtype
    inner = x + scalar(0.044715, dt) * (x * x * x)
    cdf = scalar(0.5, dt) * (torch.tanh(scalar(math.sqrt(2.0 / math.pi), dt) * inner) + 1.0)
    return x * cdf


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``jnp.logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))`` (``x`` where that is NaN)."""
    out = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def associative_scan(fn, elems: Tuple[torch.Tensor, ...], dim: int = 1):
    """``jax.lax.associative_scan(fn, elems, axis=dim)``: the same odd / even
    recursion in whole-tensor strided ops (log2(n) levels), so ``fn``
    combines the same pairs in the same order as the reference."""

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    def interleave(even, odd):
        n_odd = odd.shape[dim]
        both = torch.stack([sl(even, 0, n_odd), odd], dim=dim + 1)
        both = both.flatten(dim, dim + 1)
        return torch.cat([both, sl(even, n_odd)], dim=dim) if even.shape[dim] > n_odd else both

    def scan(xs):
        n = xs[0].shape[dim]
        if n < 2:
            return xs
        odd = scan(fn([sl(x, 0, -1, 2) for x in xs], [sl(x, 1, None, 2) for x in xs]))
        left = [sl(o, 0, -1) for o in odd] if n % 2 == 0 else odd
        even = fn(left, [sl(x, 2, None, 2) for x in xs])
        even = [torch.cat([sl(x, 0, 1), e], dim=dim) for x, e in zip(xs, even)]
        return [interleave(e, o) for e, o in zip(even, odd)]

    return tuple(scan(list(elems)))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``dtype``: of the output, when not ``x``'s (a float32 residual sum
    normed before its rounding, see ``blocks._block``)."""
    dt = dtype or x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``cap * tanh(x / cap)``, the division by the constant a multiply by
    its reciprocal in ``x``'s dtype, as XLA folds it."""
    if cap is None:
        return x
    return cap * torch.tanh(x * scalar(1.0 / cap, x.dtype))


def position(at, device) -> torch.Tensor:
    """A decode position as a 0-d int32 tensor on ``device``: a tensor as
    it is (cast to int32 where it is not), an int through a fill on the
    device (no copy from the host)."""
    if isinstance(at, torch.Tensor):
        return at.to(device=device, dtype=torch.int32)
    return torch.full((), int(at), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** expo)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); pos: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    ang = pos[..., None].float() * freqs  # (..., S, D/2)
    return _rotate(x, ang)


def apply_mrope(
    x: torch.Tensor, pos3: torch.Tensor, theta: float, sections: Tuple[int, int, int]
) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): pos3 (3, ..., S) gives (t, h, w) positions;
    frequency channels are partitioned into ``sections`` (sum = D/2)."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    # (half,) section of each channel, made on the device (a CUDA graph
    # cannot copy a host list in)
    lane = torch.arange(half, device=x.device)
    sec_id = (lane >= sections[0]).long() + (lane >= sections[0] + sections[1]).long()
    pos = torch.movedim(pos3[sec_id], 0, -1)  # (..., S, half)
    ang = pos.float() * freqs
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def device_of(gen: Optional[torch.Generator]) -> torch.device:
    """Where an initializer puts its tensors: the generator's device, or
    ``meta`` for ``None`` (shapes and dtypes only, as ``jax.eval_shape``)."""
    return torch.device("meta") if gen is None else gen.device


def normal(gen: Optional[torch.Generator], shape, std: float, dtype) -> torch.Tensor:
    """Standard normal float32 draws from ``gen`` (on its device) times
    ``std``, cast to ``dtype``."""
    z = torch.randn(shape, generator=gen, device=device_of(gen), dtype=torch.float32)
    return (z * std).to(dtype)


def uniform(gen: Optional[torch.Generator], shape, lo: float, hi: float) -> torch.Tensor:
    """Uniform float32 draws in [lo, hi) from ``gen``."""
    u = torch.rand(shape, generator=gen, device=device_of(gen), dtype=torch.float32)
    return lo + (hi - lo) * u


def zeros(gen: Optional[torch.Generator], shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device_of(gen))


def ones(gen: Optional[torch.Generator], shape, dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device_of(gen))


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int, dtype) -> torch.Tensor:
    return normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int, dtype) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype)
