"""The 10 assigned architectures: a port of ``repro.configs.archs``.

Every entry is selectable via ``--arch <id>`` in the launchers. SMOKE holds
the reduced same-family configs used by the CPU tests (small widths, few
layers/experts, tiny vocab). Each config equals the reference's field by
field, with ``torch`` dtypes in place of ``jnp`` ones.
"""

from __future__ import annotations

from repro_torch.models.common import ArchConfig, MoEConfig, SSMConfig

ARCHS = {
    # — dense —
    # [hf:Qwen/Qwen2.5-0.5B; hf] GQA, QKV bias
    "qwen2.5-32b": ArchConfig(
        name="qwen2.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1e6,
        pattern=("global",),
    ),
    # [arXiv:2408.00118; hf] local+global alternating, logit softcap
    "gemma2-9b": ArchConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
        d_ff=14336, vocab=256000, act="geglu",
        attn_softcap=50.0, logit_softcap=30.0, window=4096,
        pattern=("local", "global"), post_norm=True, tie_embeddings=True,
        rope_theta=1e4,
    ),
    # [hf:Qwen/Qwen3-8B; hf] qk_norm, GQA
    "qwen3-1.7b": ArchConfig(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
        d_ff=6144, vocab=151936, qk_norm=True, rope_theta=1e6,
        pattern=("global",), tie_embeddings=True,
    ),
    # [hf:Qwen/Qwen1.5-0.5B; hf] QKV bias
    "qwen1.5-110b": ArchConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=49152, vocab=152064, qkv_bias=True, rope_theta=1e6,
        pattern=("global",),
    ),
    # — MoE —
    # [arXiv:2409.02060; hf] 64 experts top-8
    "olmoe-1b-7b": ArchConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1024, vocab=50304, qk_norm=True, rope_theta=1e4,
        pattern=("global",),
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    ),
    # [hf:microsoft/Phi-3.5-MoE-instruct; hf] 16 experts top-2
    "phi3.5-moe-42b-a6.6b": ArchConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=6400, vocab=32064, rope_theta=1e4,
        pattern=("global",),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
    ),
    # — hybrid —
    # [arXiv:2402.19427; hf] RG-LRU + local attn, 1:2. Exactly 26 layers:
    # (rec, rec, local) x 8 + (rec, rec) tail, expressed as one full pattern
    # (n_groups == 1; the model is small enough to unroll).
    "recurrentgemma-2b": ArchConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
        d_ff=7680, vocab=256000, act="geglu", window=2048,
        pattern=("recurrent", "recurrent", "local") * 8 + ("recurrent", "recurrent"),
        d_rnn=2560, tie_embeddings=True, rope_theta=1e4,
    ),
    # — audio (enc-dec, conv frontend stubbed to frame embeddings) —
    # [arXiv:2212.04356; unverified]
    "whisper-base": ArchConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
        d_ff=2048, vocab=51865, act="gelu",
        pattern=("global",), cross_attention=True,
        enc_layers=6, enc_seq=1500, rope_theta=1e4,
    ),
    # — VLM backbone (M-RoPE; vision frontend stubbed to position ids) —
    # [arXiv:2409.12191; hf]
    "qwen2-vl-7b": ArchConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
        d_ff=18944, vocab=152064, qkv_bias=True, rope_theta=1e6,
        pattern=("global",), mrope_sections=(16, 24, 24),
    ),
    # — SSM —
    # [arXiv:2405.21060; unverified] SSD (state-space duality)
    "mamba2-130m": ArchConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab=50280,
        pattern=("ssd",),
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_width=4, chunk=128),
        tie_embeddings=True,
    ),
}


def _smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config: tiny widths, few layers, small vocab."""
    import dataclasses

    pattern = cfg.pattern if len(cfg.pattern) <= 4 else cfg.pattern[:3]
    kw = dict(
        pattern=pattern,
        n_layers=2 * len(pattern),
        d_model=64,
        vocab=512,
        enc_seq=0 if cfg.enc_layers == 0 else 16,
        enc_layers=0 if cfg.enc_layers == 0 else 2,
        remat="none",
    )
    if cfg.family != "ssm":
        kw.update(
            n_heads=4,
            n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2,
            d_head=16,
            d_ff=0 if cfg.d_ff == 0 else 128,
        )
        if cfg.window is not None:
            kw["window"] = 8
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff_expert=32
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=8, chunk=16)
    if cfg.d_rnn is not None:
        kw["d_rnn"] = 64
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (4, 2, 2)  # sums to d_head/2 = 8
    return dataclasses.replace(cfg, **kw)


SMOKE = {name: _smoke(cfg) for name, cfg in ARCHS.items()}


def get(name: str) -> ArchConfig:
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    return SMOKE[name]


def list_archs():
    return sorted(ARCHS.keys())
