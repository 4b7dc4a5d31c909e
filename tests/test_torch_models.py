"""The port's model stack (``repro_torch.configs`` / ``repro_torch.models``)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; parameters are the reference's own
``lm.init_params``, carried across by ``models.bridge.params_from_numpy``.
What was measured, and the tolerances it sets:

  * float32 compute: every logit and cache entry within 4.2e-6 of the
    reference at output scales up to 4.1 (the elementwise functions, exp,
    rsqrt, sin, cos, tanh, are XLA's own polynomials there and differ from
    PyTorch's in the last bits). Tolerance: ``F32_TOL`` (1e-5) of the
    tensor's largest magnitude.
  * bfloat16 compute (the configs' own): the port rounds each elementwise
    step where the reference's XLA program rounds it (``common.silu`` /
    ``gelu`` / ``sigmoid`` as the source's steps; a value the source casts
    straight to float32, such as a residual sum read by the next norm, stays
    unrounded, as XLA leaves it). Logits, caches and dropped slots are then
    bit-equal for 8 of the 10 archs; whisper-base's non-causal encoder stays
    within 0.0050 of the logits' scale, recurrentgemma-2b and mamba2-130m
    within 0.0014 (XLA's own exp / log1p in their gates). Before this
    rounding (``F.silu``, a rounded residual): up to 0.0212, and olmoe's
    router flipped at near-ties (97.9 % of its logits within 2**-5).
    Tolerance: ``BF16_TOL`` (2**-7) of the largest magnitude, for every
    logit (``MOE_BF16_SHARE`` 1.0: the MoE archs too).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_params, port_arch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SMOKE as J_SMOKE
from repro.configs import shapes as jshapes
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.configs import get_smoke, list_archs
from repro_torch.configs import shapes as tshapes
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import bridge
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp

F32_TOL = 1e-5
BF16_TOL = 2.0**-7
MOE_BF16_SHARE = 1.0
# every arch: each block kind is ported (attention, RG-LRU, SSD)
PORTED = ["qwen2.5-32b", "gemma2-9b", "qwen3-1.7b", "qwen1.5-110b", "olmoe-1b-7b",
          "phi3.5-moe-42b-a6.6b", "whisper-base", "qwen2-vl-7b", "recurrentgemma-2b",
          "mamba2-130m"]
B, S = 2, 24


def J(a):
    return None if a is None else jnp.asarray(a)


def T(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(want, got, tol, share=1.0, what=""):
    """|got - want| <= tol * max|want| at (at least a ``share`` of) every
    entry."""
    want, got = as_np(want), as_np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = np.abs(want - got)
    held = float((err <= bound).mean())
    assert held >= share, f"{what}: max err {err.max():.4g} > {bound:.4g} at {1 - held:.2%}"


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_equal_the_reference_field_by_field():
    assert list_archs() == sorted(J_ARCHS)
    for table_j, table_t in ((J_ARCHS, T_ARCHS), (J_SMOKE, T_SMOKE)):
        assert sorted(table_j) == sorted(table_t)
        for name, jc in table_j.items():
            assert port_arch(jc) == table_t[name], name
            assert table_t[name].n_groups == jc.n_groups
    assert T_ARCHS["qwen3-1.7b"].compute_dtype is torch.bfloat16
    assert T_ARCHS["qwen3-1.7b"].param_dtype is torch.float32
    assert tshapes.SHAPES == {k: tshapes.ShapeSpec(**dataclasses.asdict(v))
                              for k, v in jshapes.SHAPES.items()}
    assert list(tshapes.cells(list_archs())) == [
        (a, tshapes.SHAPES[s.name], skip) for a, s, skip in jshapes.cells(sorted(J_ARCHS))]


# ---------------------------------------------------------------------------
# common and mlp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_head,theta", [(16, 1e4), (64, 1e6), (128, 1e6), (256, 1e4)])
def test_rope_matches_jax(d_head, theta):
    rng = np.random.default_rng(d_head)
    x = rng.standard_normal((2, 37, 3, d_head)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1000, 1037, dtype=np.int32), (2, 37))
    assert_close(jcm.rope_freqs(d_head, theta), tcm.rope_freqs(d_head, theta), F32_TOL)
    # angles up to ~1000 rad: sin / cos of large arguments differ in the
    # last bits between XLA and PyTorch, scaled by the angle
    assert_close(jcm.apply_rope(J(x), J(pos), theta), tcm.apply_rope(T(x), T(pos), theta),
                 1e-4, what="rope f32")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = tcm.apply_rope(T(x).bfloat16(), T(pos), theta)
    assert got.dtype == torch.bfloat16
    assert_close(jcm.apply_rope(xb, J(pos), theta), got, BF16_TOL, what="rope bf16")


def test_mrope_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, 4, 16)).astype(np.float32)
    pos3 = rng.integers(0, 64, (3, 2, 19)).astype(np.int32)
    assert_close(jcm.apply_mrope(J(x), J(pos3), 1e6, (4, 2, 2)),
                 tcm.apply_mrope(T(x), T(pos3), 1e6, (4, 2, 2)), F32_TOL)


def test_norms_and_softcap_match_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 7, 64)) * 3).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    bias = rng.standard_normal(64).astype(np.float32)
    assert_close(jcm.rms_norm(J(scale), J(x)), tcm.rms_norm(T(scale), T(x)), F32_TOL)
    assert_close(jcm.rms_norm(J(scale), J(x).astype(jnp.bfloat16)),
                 tcm.rms_norm(T(scale), T(x).bfloat16()), BF16_TOL)
    ln = {"scale": scale, "bias": bias}
    assert_close(jcm.layer_norm({k: J(v) for k, v in ln.items()}, J(x)),
                 tcm.layer_norm({k: T(v) for k, v in ln.items()}, T(x)), F32_TOL)
    assert_close(jcm.softcap(J(x), 2.5), tcm.softcap(T(x), 2.5), F32_TOL)
    assert tcm.softcap(T(x), None) is not None


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlp_matches_jax(act, dtype):
    jc = dataclasses.replace(J_SMOKE["qwen3-1.7b"], act=act, compute_dtype=jnp.dtype(dtype))
    tc = port_arch(jc)
    jp = jmlp.init_mlp_params(jax.random.PRNGKey(3), jc)
    if act == "gelu":  # non-zero biases, so they are checked
        jp = dict(jp, b_up=jnp.full_like(jp["b_up"], 0.1), b_down=jnp.full_like(jp["b_down"], -0.2))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(7).standard_normal((2, 9, jc.d_model)).astype(np.float32) * 2
    want = jmlp.mlp(jp, jc, J(x).astype(jc.compute_dtype))
    got = tmlp.mlp(tp, tc, T(x).to(tc.compute_dtype))
    assert got.dtype == tc.compute_dtype
    assert_close(want, got, F32_TOL if dtype == "float32" else BF16_TOL, what=act)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(tmlp.gelu(T(x)).numpy(), np.asarray(jax.nn.gelu(J(x))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(rng, Sq, Sk, H, Hk, D):
    q = rng.standard_normal((1, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((1, Sk, Hk, D)).astype(np.float32)
    v = rng.standard_normal((1, Sk, Hk, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("Sq,Sk,window", [
    (24, 24, None),  # dense
    (24, 40, 8),  # dense, windowed
    (1500, 1500, None),  # Sq * Sk > 4 * 512 * 1024: the streaming path, a ragged last block
    (1100, 2048, 300),  # streaming, windowed, two whole blocks
])
def test_dot_attention_matches_jax(grouped, Sq, Sk, window):
    jc = dataclasses.replace(J_SMOKE["qwen2.5-32b"], gqa_grouped=grouped, attn_softcap=None)
    tc = port_arch(jc)
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = _qkv(rng, Sq, Sk, 4, 2, 16)
    q_pos = np.arange(Sk - Sq, Sk, dtype=np.int32)
    k_pos = np.arange(Sk, dtype=np.int32)
    for dt in ("float32", "bfloat16"):
        want = jax.jit(lambda *a: jattn.dot_attention(jc, *a, True, window))(
            *(J(a).astype(dt) for a in (q, k, v)), J(q_pos), J(k_pos))
        tdt = getattr(torch, dt)
        got = tattn.dot_attention(tc, *(T(a).to(tdt) for a in (q, k, v)), T(q_pos), T(k_pos),
                                  True, window)
        assert got.dtype == tdt
        assert_close(want, got, F32_TOL if dt == "float32" else BF16_TOL, what=dt)


def test_attention_softcap_and_repeat_kv_match_jax():
    jc = J_SMOKE["gemma2-9b"]  # attn_softcap 50
    tc = port_arch(jc)
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 12, 12, 4, 2, 16)
    q = q * 30  # logits large enough for the softcap to bite
    pos = np.arange(12, dtype=np.int32)
    want = jattn.dot_attention(jc, J(q), J(k), J(v), J(pos), J(pos), True, None)
    got = tattn.dot_attention(tc, T(q), T(k), T(v), T(pos), T(pos), True, None)
    assert_close(want, got, F32_TOL)
    kk = T(k)
    np.testing.assert_array_equal(tattn._repeat_kv(kk, 4).numpy(),
                                  np.asarray(jattn._repeat_kv(J(k), 4)))


def _attend_both(arch, x, pos, kind, S_cache, at, cache_np=None):
    jc = J_SMOKE[arch]
    tc = port_arch(jc)
    jp = jattn.init_attn_params(jax.random.PRNGKey(11), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    if cache_np is None:
        jcache = jattn.KVCache.zeros(jc, x.shape[0], S_cache)
        tcache = tattn.KVCache.zeros(tc, x.shape[0], S_cache, "cpu")
    else:
        jcache = jattn.KVCache(*(J(a) for a in cache_np))
        tcache = bridge.cache_from_numpy({"c": cache_np}, "cpu")["c"]
    xb = J(x).astype(jc.compute_dtype)
    jo, jn = jax.jit(lambda p, x, pos, c: jattn.attend(p, jc, x, pos, kind, cache=c, cache_at=at))(
        jp, xb, J(pos), jcache)
    to, tn = tattn.attend(tp, tc, T(x).to(tc.compute_dtype), T(pos), kind, cache=tcache, cache_at=at)
    return jo, jn, to, tn


def test_prefill_longer_than_the_ring_matches_jax():
    """A local layer's ring (window 8) fed a 21-token prompt: the window mask
    over the sequence, then the last 8 entries slot-aligned (slot = pos % 8)."""
    x = np.random.default_rng(12).standard_normal((2, 21, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 24, dtype=np.int32), (2, 21))
    jo, jn, to, tn = _attend_both("gemma2-9b", x, pos, "local", 8, at=3)
    assert_close(jo, to, BF16_TOL, what="out")
    np.testing.assert_array_equal(np.asarray(jn.pos), tn.pos.numpy())
    np.testing.assert_array_equal(tn.pos.numpy() % 8, np.arange(8))
    for a, b in ((jn.k, tn.k), (jn.v, tn.v)):
        assert_close(a, b, BF16_TOL)


def test_cache_write_is_clamped_as_dynamic_update_slice():
    """Writing 4 tokens at 14 % 16 into a 16-slot cache: ``dynamic_update_slice``
    clamps the start to 12, and so does the port; the positions written are
    still 14 .. 17."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1, 4, 64)).astype(np.float32)
    pos = np.arange(14, 18, dtype=np.int32)[None]
    jc = J_SMOKE["qwen3-1.7b"]
    shp = (1, 16, jc.n_kv_heads, jc.d_head)
    cache = (rng.standard_normal(shp).astype(np.float32), rng.standard_normal(shp).astype(np.float32),
             np.arange(16, dtype=np.int32))
    cache = tuple(np.asarray(J(a).astype(jc.compute_dtype)) if a.dtype == np.float32 else a
                  for a in cache)
    jo, jn, to, tn = _attend_both("qwen3-1.7b", x, pos, "global", 16, at=14, cache_np=cache)
    np.testing.assert_array_equal(np.asarray(jn.pos), tn.pos.numpy())
    np.testing.assert_array_equal(tn.pos.numpy()[12:], [14, 15, 16, 17])
    np.testing.assert_array_equal(np.asarray(jn.k[:, :12], np.float32), tn.k[:, :12].float().numpy())
    assert_close(jn.k, tn.k, BF16_TOL)
    assert_close(jo, to, BF16_TOL)


def test_kv_cache_zeros_keeps_the_reference_positions():
    """An empty cache's ``pos`` is ``arange``, as the reference's (a slot not
    yet written reads as that position)."""
    tc = T_SMOKE["qwen3-1.7b"]
    c = tattn.KVCache.zeros(tc, 2, 10, "cpu")
    want = jattn.KVCache.zeros(J_SMOKE["qwen3-1.7b"], 2, 10)
    np.testing.assert_array_equal(c.pos.numpy(), np.asarray(want.pos))
    assert c.k.dtype == torch.bfloat16 and tuple(c.k.shape) == want.k.shape


# ---------------------------------------------------------------------------
# whole models at smoke width
# ---------------------------------------------------------------------------


def _inputs(jc, seed=2):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    enc = (rng.standard_normal((B, jc.enc_seq, jc.d_model)).astype(np.float32)
           if jc.enc_layers else None)
    pos3 = None
    if jc.mrope_sections is not None:
        ar = np.arange(S, dtype=np.int32)
        pos3 = np.stack([np.broadcast_to(a, (B, S)) for a in (ar, ar // 2, ar % 5)])
    return tok, enc, pos3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", PORTED)
def test_model_matches_jax(arch, dtype):
    """forward, prefill (S - 1 tokens into a cache of S + 8) and decode_step:
    logits, caches and the MoE dropped-slot count."""
    jc = dataclasses.replace(J_SMOKE[arch], compute_dtype=jnp.dtype(dtype))
    tc = port_arch(jc)
    jp, tp = jax_params(jc, seed=1)
    tok, enc, pos3 = _inputs(jc)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    share = MOE_BF16_SHARE if (jc.moe is not None and dtype == "bfloat16") else 1.0

    jl, ja = jax.jit(lambda *a: jlm.forward(jc, *a))(jp, J(tok), J(pos3), J(enc))
    tl, ta = tlm.forward(tc, tp, T(tok), T(pos3), T(enc))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, S, jc.vocab)
    assert_close(jl, tl, tol, share, "forward")
    if share == 1.0:
        assert int(ja["moe_dropped_slots"]) == int(ta["moe_dropped_slots"])

    p3 = None if pos3 is None else pos3[:, :, : S - 1]
    jcache = jlm.init_cache(jc, B, S + 8)
    tcache = tlm.init_cache(tc, B, S + 8, "cpu")
    jpf, jcache = jax.jit(lambda *a: jlm.prefill(jc, *a))(jp, J(tok[:, : S - 1]), jcache, J(p3),
                                                           J(enc))
    tpf, tcache = tlm.prefill(tc, tp, T(tok[:, : S - 1]), tcache, T(p3), T(enc))
    assert_close(jpf, tpf, tol, share, "prefill")
    want_c = jax.tree.map(np.asarray, jcache)
    got_c = bridge.cache_to_numpy(tcache)
    for name in want_c:
        assert type(want_c[name]).__name__ == type(got_c[name]).__name__
        for f in want_c[name]._fields:  # KVCache (k, v, pos); RGLRUState / SSDState (h, conv)
            if f == "pos":
                np.testing.assert_array_equal(want_c[name].pos, got_c[name].pos)
            else:
                assert_close(getattr(want_c[name], f), getattr(got_c[name], f), tol, share,
                             f"cache {f}")

    jd, _ = jax.jit(lambda *a: jlm.decode_step(jc, *a))(
        jp, J(tok[:, S - 1:]), jnp.asarray(S - 1, jnp.int32), jcache, None, J(enc))
    td, _ = tlm.decode_step(tc, tp, T(tok[:, S - 1:]), S - 1, tcache, None, T(enc))
    assert_close(jd, td, tol, share, "decode")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-9b", "recurrentgemma-2b", "mamba2-130m"])
def test_decode_matches_forward(arch):
    """The port's own contract between its training and serving paths, as
    ``tests/test_models.py`` holds the reference to it: prefill(S - 1) plus
    one decode_step reproduces forward's last logits (rtol = atol = 0.05)."""
    tc = get_smoke(arch)
    p = tlm.init_params(tc, 2, "cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, tc.vocab, (B, S)).astype(np.int32))
    full, _ = tlm.forward(tc, p, tok)
    caches = tlm.init_cache(tc, B, S + 4, "cpu")
    _, caches = tlm.prefill(tc, p, tok[:, : S - 1], caches)
    dec, _ = tlm.decode_step(tc, p, tok[:, S - 1:], S - 1, caches)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), rtol=0.05, atol=0.05)


def test_init_params_has_the_reference_tree():
    """Same key paths, shapes and dtypes as ``lm.init_params``; the port
    draws from a ``torch.Generator`` (a seed, or a generator as given)."""
    for arch in PORTED:
        jc = J_SMOKE[arch]
        want = jax.eval_shape(lambda: jlm.init_params(jc, jax.random.PRNGKey(0)))
        got = tlm.init_params(T_SMOKE[arch], torch.Generator().manual_seed(0), "cpu")
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [jax.tree_util.keystr(p) for p, _ in flat_w] == \
            [jax.tree_util.keystr(p) for p, _ in flat_g], arch
        for (_, w), (_, g) in zip(flat_w, flat_g):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    a = tlm.init_params(T_SMOKE["qwen3-1.7b"], 7, "cpu")
    b = tlm.init_params(T_SMOKE["qwen3-1.7b"], 7, "cpu")
    assert torch.equal(a["stack"]["b0"]["mixer"]["wq"], b["stack"]["b0"]["mixer"]["wq"])


def test_bridge_round_trips_params_and_bf16_caches():
    jc = J_SMOKE["gemma2-9b"]
    jp, tp = jax_params(jc)
    back = bridge.params_to_numpy(tp)
    for (_, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0],
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(w, g)
    jcache = jax.tree.map(lambda a: a + 1, jlm.init_cache(jc, 2, 12))
    want = jax.tree.map(np.asarray, jcache)
    tcache = bridge.cache_from_numpy(want, "cpu")
    assert tcache["b0"].k.dtype == torch.bfloat16
    got = bridge.cache_to_numpy(tcache)
    for name in want:
        for f in ("k", "v", "pos"):
            a, b = getattr(want[name], f), getattr(got[name], f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint16) if f != "pos" else a,
                                          b.view(np.uint16) if f != "pos" else b)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-130m"])
def test_recurrent_and_ssd_blocks_are_not_ported_yet(arch):
    """They are ported now: the blocks build, and their caches are the
    reference's (``RGLRUState`` / ``SSDState``: fields, shapes, dtypes)."""
    tc, jc = T_SMOKE[arch], J_SMOKE[arch]
    kind = tc.pattern[0]
    got = tblocks.init_block_cache(tc, kind, 1, 8, "cpu")
    want = jax.eval_shape(lambda: jblocks.init_block_cache(jc, kind, 1, 8))
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == getattr(torch, str(w.dtype))
    assert set(tblocks.init_block_params(torch.Generator().manual_seed(0), tc, kind)) == \
        set(jax.eval_shape(lambda: jblocks.init_block_params(jax.random.PRNGKey(0), jc, kind)))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.init_params(T_SMOKE["qwen3-1.7b"], 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.init_cache(T_SMOKE["qwen3-1.7b"], 1, 8)


def test_decode_gap_at_2048_is_the_reference_s():
    """Decode after prefill against forward's last logits at S = 2048
    (streaming attention in forward and prefill, dense in decode), bfloat16:
    the reference shows the same gap as the port, so the gap is the
    algorithm's, not the port's (``scripts/torch_decode_gap.py`` measures it
    at the full width cut to 2 layers: 0.0234375 in both packages). Here at
    the smoke width: each gap within a factor 2 of the other, both inside
    rtol = atol = 0.05."""
    jc = dataclasses.replace(J_SMOKE["qwen3-1.7b"], n_layers=2)
    tc = port_arch(jc)
    jp, tp = jax_params(jc, seed=0)
    n = 2048
    tok = np.random.default_rng(n).integers(0, jc.vocab, (1, n)).astype(np.int32)
    jfull = np.asarray(jax.jit(lambda p, t: jlm.forward(jc, p, t)[0][:, -1])(jp, tok))
    _, cache = jax.jit(lambda p, t, c: jlm.prefill(jc, p, t, c))(
        jp, tok[:, : n - 1], jlm.init_cache(jc, 1, n + 4))
    jdec = np.asarray(jax.jit(lambda p, t, c: jlm.decode_step(jc, p, t, jnp.int32(n - 1), c)[0])(
        jp, tok[:, n - 1:], cache))[:, 0]
    tt = T(tok)
    tfull = tlm.forward(tc, tp, tt)[0][:, -1].numpy()
    _, tcache = tlm.prefill(tc, tp, tt[:, : n - 1], tlm.init_cache(tc, 1, n + 4, "cpu"))
    tdec = tlm.decode_step(tc, tp, tt[:, n - 1:], n - 1, tcache)[0][:, 0].numpy()
    ref_gap = float(np.abs(jdec - jfull).max())
    port_gap = float(np.abs(tdec - tfull).max())
    assert ref_gap > 0 and 0.5 <= port_gap / ref_gap <= 2.0, (ref_gap, port_gap)
    for dec, full in ((jdec, jfull), (tdec, tfull)):
        np.testing.assert_allclose(dec, full, rtol=0.05, atol=0.05)
