"""The decode step with a device position, and the serve driver's compiled
decode (``repro_torch.launch.serve.CompiledDecode``), on the CPU.

The reference's ``lm.decode_step`` takes its position as a device scalar
(``index: jax.Array``) and writes the cache with ``dynamic_update_slice``
at a clamped start. The port's takes an int or a 0-d int32 tensor and
writes the cache with ``index_copy_`` at ``clamp(at % S_cache, max=S_cache
- S)``, never reading the position on the host, so a CUDA graph of the step
replays any position. Here:

  * a 0-d int32 position gives the int form's logits and caches bit for
    bit, for every smoke arch that decodes (whisper-base needs its encoder
    frames in both packages), at positions 0, ``S_cache - 1`` and past
    ``S_cache`` (a windowed ring wraps), and the ``pos`` row is written
    where the reference's clamped update writes it;
  * past the ring, gemma2-9b's decode (local and global layers) equals the
    jitted reference given a device position;
  * ``CompiledDecode``'s body over static buffers equals ``lm.decode_step``
    from a fresh cache, keeps one body a batch size and leaves its static
    cache fresh (zeros, ``pos = arange``) after every call.

The serve driver, which decodes through ``CompiledDecode``, is held to the
live JAX loop in ``test_torch_serving.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from _torch_parity import jax_params, port_arch
from test_torch_models import F32_TOL, assert_close

from repro.configs import SMOKE as J_SMOKE
from repro.models import lm as jlm
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models import bridge
from repro_torch.models import lm as tlm
from repro_torch.models.attention import KVCache

S_CACHE = 16  # a global layer's slots; a local layer's ring: min(16, window 8)
PROMPT = 6
POSITIONS = (0, S_CACHE - 1, S_CACHE + 5)  # the last wraps every ring
DECODING = ["qwen2.5-32b", "gemma2-9b", "qwen3-1.7b", "qwen1.5-110b", "olmoe-1b-7b",
            "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b", "qwen2-vl-7b", "mamba2-130m"]


def _prefilled(cfg, seed=3):
    """Parameters, a (2, 1) token and caches holding a 6-token prefill."""
    p = tlm.init_params(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (2, PROMPT + 1), generator=g, dtype=torch.int32)
    _, caches = tlm.prefill(cfg, p, tok[:, :PROMPT], tlm.init_cache(cfg, 2, S_CACHE, "cpu"))
    return p, tok[:, PROMPT:], caches


def _leaves(tree):
    return pytree.tree_flatten(tree, is_leaf=lambda x: x is None)[0]


@pytest.mark.parametrize("at", POSITIONS)
@pytest.mark.parametrize("arch", DECODING)
def test_device_position_equals_the_int_form(arch, at):
    cfg = get_smoke(arch)
    p, tok, caches = _prefilled(cfg)
    want, want_c = tlm.decode_step(cfg, p, tok, at, caches)
    got, got_c = tlm.decode_step(cfg, p, tok, torch.tensor(at, dtype=torch.int32), caches)
    assert torch.equal(got, want)
    for a, b in zip(_leaves(got_c), _leaves(want_c), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for name, old in caches.items():
        if isinstance(old, KVCache):  # (n_groups, S) positions a layer
            pos = old.pos.numpy().copy()
            slots = pos.shape[-1]
            pos[:, min(at % slots, slots - 1)] = at
            np.testing.assert_array_equal(got_c[name].pos.numpy(), pos)


def test_decode_past_the_ring_equals_the_reference():
    """gemma2-9b at float32 compute, a 6-token prefill, then decode at
    position 21: its local layers' 8-slot rings wrap (slot 5), its global
    layers write slot 5 of 16; the reference takes ``jnp.int32(21)``."""
    jc = dataclasses.replace(J_SMOKE["gemma2-9b"], compute_dtype=jnp.float32)
    tc = port_arch(jc)
    jp, tp = jax_params(jc, seed=4)
    tok = np.random.default_rng(4).integers(0, jc.vocab, (2, PROMPT + 1)).astype(np.int32)
    jcache = jlm.init_cache(jc, 2, S_CACHE)
    _, jcache = jax.jit(lambda *a: jlm.prefill(jc, *a))(jp, jnp.asarray(tok[:, :PROMPT]), jcache)
    tcache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    at = S_CACHE + 5
    jd, jn = jax.jit(lambda *a: jlm.decode_step(jc, *a))(
        jp, jnp.asarray(tok[:, PROMPT:]), jnp.int32(at), jcache)
    td, tn = tlm.decode_step(tc, tp, torch.from_numpy(tok[:, PROMPT:]),
                             torch.tensor(at, dtype=torch.int32), tcache)
    assert_close(jd, td, F32_TOL, what="decode")
    want = jax.tree.map(np.asarray, jn)
    got = bridge.cache_to_numpy(tn)
    for name in want:
        np.testing.assert_array_equal(want[name].pos, got[name].pos)
        assert_close(want[name].k, got[name].k, F32_TOL, what=f"{name}.k")


def test_compiled_decode_equals_decode_step():
    """The body over static buffers at B = 1, 2, 3 (and B = 2 again, at
    another position): the logits of ``lm.decode_step`` from a fresh cache
    of ``S_MAX`` slots, one body a batch size, the static cache untouched."""
    cfg = get_smoke("qwen3-1.7b")
    p = tlm.init_params(cfg, 0, "cpu")
    dec = tserve.CompiledDecode(cfg, p)
    g = torch.Generator().manual_seed(0)
    for B, at in ((1, 4), (2, 9), (3, 15), (2, 40)):
        tok = torch.randint(0, cfg.vocab, (B, 1), generator=g, dtype=torch.int32)
        got = dec(tok, at).clone()
        want, _ = tlm.decode_step(cfg, p, tok, at, tlm.init_cache(cfg, B, tserve.S_MAX, "cpu"))
        assert torch.equal(got, want), (B, at)
    assert sorted(dec.steps) == [1, 2, 3]
    for B, body in dec.steps.items():
        fresh = tlm.init_cache(cfg, B, tserve.S_MAX, "cpu")
        for a, b in zip(_leaves(body.cache), _leaves(fresh), strict=True):
            assert torch.equal(a, b)
        assert body.graph is None  # the CPU runs the body
