"""The port's RG-LRU and SSD blocks (``repro_torch.models.rglru`` /
``ssd``) against the JAX package's, on the CPU at smoke width.

Parameters are the reference's own (``init_rglru_params`` /
``init_ssd_params``), carried across by ``models.bridge``; inputs come from
numpy with a seed; the JAX side runs under ``jax.jit``. What was measured,
and the tolerances it sets:

  * ``common.associative_scan`` is ``jax.lax.associative_scan``'s recursion,
    and the RG-LRU combine rounds its multiply-add once as XLA's CPU code
    contracts it: bit-equal at every length tried (``test_associative_scan``).
  * float32 compute: block outputs and states within 3.3e-6 of their scale
    (the projections' sums and XLA's exp / log1p differ in the last bits).
    Tolerance ``F32_TOL`` (1e-5 of the largest magnitude).
  * bfloat16 compute: the blocks round each step where the reference's XLA
    program rounds it (a value read only as float32 stays unrounded): most
    outputs bit-equal, all within 0.0022 of their scale. Tolerance
    ``BF16_TOL`` (2**-8, one bfloat16 ulp at the top of the scale).
  * gradients (float32, at a chunk-padded length) against ``jax.grad``:
    within 4.7e-6 of each leaf's scale, ``A_log``'s (a sum over every
    position and channel of a head) within 1.24e-5; no NaN. Tolerance
    ``GRAD_TOL`` (5e-5).
  * recurrentgemma-2b's bfloat16 decode-after-prefill gap at S = 2048 is
    the reference's: each package's within a factor 2 of the other's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import port_arch

from repro.configs import SMOKE as J_SMOKE
from repro.models import rglru as jrg
from repro.models import ssd as jssd
from repro_torch.models import bridge
from repro_torch.models import common as tcm
from repro_torch.models import rglru as trg
from repro_torch.models import ssd as tssd

F32_TOL = 1e-5
BF16_TOL = 2.0**-8
GRAD_TOL = 5e-5

FAMILIES = {
    "rglru": ("recurrentgemma-2b", jrg.init_rglru_params, jrg.rglru_block, jrg.init_rglru_state,
              trg.rglru_block, trg.init_rglru_state),
    "ssd": ("mamba2-130m", jssd.init_ssd_params, jssd.ssd_block, jssd.init_ssd_state,
            tssd.ssd_block, tssd.init_ssd_state),
}


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(want, got, tol, what=""):
    want, got = as_np(want), as_np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert np.isfinite(got).all(), what
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(want - got).max())
    assert err <= bound, f"{what}: max err {err:.4g} > {bound:.4g}"


def _setup(family, dtype):
    arch, jinit, jblock, jstate, tblock, tstate = FAMILIES[family]
    jc = dataclasses.replace(J_SMOKE[arch], compute_dtype=jnp.dtype(dtype))
    tc = port_arch(jc)
    jp = jinit(jax.random.PRNGKey(1), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp, jblock, jstate, tblock, tstate


def _x(shape, seed, dtype_j, dtype_t):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype_j), torch.from_numpy(x).to(dtype_t)


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, b1 * a2 + b2


@pytest.mark.parametrize("S", [1, 2, 3, 7, 16, 33, 100, 257])
def test_associative_scan(S):
    """The RG-LRU's scan on the same (a, b): bit-equal to the jitted
    ``jax.lax.associative_scan``, both outputs."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 5)).astype(np.float32)
    b = rng.standard_normal((2, S, 5)).astype(np.float32)
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(_combine, (a, b), axis=1))(a, b)
    ta, tb = tcm.associative_scan(trg._combine, (torch.from_numpy(a), torch.from_numpy(b)), dim=1)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


def test_segsum_matches_jax():
    """-inf strictly above the diagonal, pairwise sums below it."""
    a = -np.random.default_rng(0).uniform(0, 1, (2, 3, 16)).astype(np.float32)
    want = np.asarray(jax.jit(jssd._segsum)(a))
    got = tssd._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(want), np.isneginf(got))
    fin = np.isfinite(want)  # XLA's cumsum sums in another order
    assert_close(want[fin], got[fin], F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [37, 48])  # 37: the SSD chunk (16) pads; 48: whole chunks
@pytest.mark.parametrize("family", ["rglru", "ssd"])
def test_block_matches_jax(family, S, dtype):
    """Prefill with no state, prefill into a zero state, then a decode chain
    of 3 single steps: outputs and every state leaf."""
    jc, tc, jp, tp, jblock, jstate, tblock, tstate = _setup(family, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    cd = tc.compute_dtype
    xj, xt = _x((2, S, jc.d_model), S, jc.compute_dtype, cd)
    run = jax.jit(lambda p, x, s: jblock(p, jc, x, s))

    jo, _ = jax.jit(lambda p, x: jblock(p, jc, x))(jp, xj)
    to, ts = tblock(tp, tc, xt)
    assert ts is None and to.dtype == cd
    assert_close(jo, to, tol, "prefill, no state")

    js, ts = jstate(jc, 2), tstate(tc, 2, "cpu")
    for step in range(4):
        if step:
            xj, xt = _x((2, 1, jc.d_model), 100 + step, jc.compute_dtype, cd)
        jo, js = run(jp, xj, js)
        to, ts = tblock(tp, tc, xt, ts)
        assert_close(jo, to, tol, f"out, step {step}")
        for f in js._fields:
            assert getattr(ts, f).dtype == getattr(torch, str(getattr(js, f).dtype)), f
            assert_close(getattr(js, f), getattr(ts, f), tol, f"state {f}, step {step}")


def test_rglru_carry_in_equals_one_prefill():
    """The carried state folds in as a virtual step 0: prefill of 20 tokens
    then 17 more equals one prefill of 37 (float32, to rounding)."""
    jc, tc, jp, tp, _, _, tblock, tstate = _setup("rglru", "float32")
    _, xt = _x((2, 37, jc.d_model), 5, jnp.float32, torch.float32)
    whole, _ = tblock(tp, tc, xt, tstate(tc, 2, "cpu"))
    a, st = tblock(tp, tc, xt[:, :20], tstate(tc, 2, "cpu"))
    b, _ = tblock(tp, tc, xt[:, 20:], st)
    assert_close(whole, torch.cat([a, b], dim=1), F32_TOL)


@pytest.mark.parametrize("family", ["rglru", "ssd"])
def test_block_gradient_matches_jax(family):
    """d/d(params, x) of sum(out * w) at S = 37 (the SSD chunk pads: the
    segsum's -inf above the diagonal must give no NaN) against
    ``jax.grad``, float32."""
    jc, tc, jp, tp, jblock, _, tblock, _ = _setup(family, "float32")
    S = 37
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jblock(p, jc, x)[0] * w)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    p = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(tblock(p, tc, xt)[0] * torch.from_numpy(w))
    grads = torch.autograd.grad(loss, [p[k] for k in sorted(p)] + [xt])
    for k, g in zip(sorted(p) + ["x"], grads):
        want = jgx if k == "x" else jgp[k]
        assert_close(want, g, GRAD_TOL, f"grad {k}")


def test_rglru_decode_gap_at_2048_is_the_reference_s():
    """recurrentgemma-2b's decode after prefill against forward's last
    logits at S = 2048 in bfloat16 (the log-depth scan and the streaming
    local attention in forward, one step at a time in decode): the
    reference shows a gap of the same size as the port, so the gap is the
    algorithm's. ``scripts/torch_decode_gap.py`` measures it at the full
    width: equal in both packages at 3 layers (0.03125 at a logit scale of
    34) and 6 (0.046875 at 27.25). Here at the smoke width cut to two
    (recurrent, recurrent, local) groups (0.0059 and 0.0044 at a logit
    scale of 0.44): each gap within a factor 2 of the other, both inside rtol = atol
    = 0.05."""
    from _torch_parity import jax_params

    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm

    base = J_SMOKE["recurrentgemma-2b"]
    jc = dataclasses.replace(base, n_layers=6, pattern=base.pattern[:6])
    tc = port_arch(jc)
    jp, tp = jax_params(jc, seed=0)
    n = 2048
    tok = np.random.default_rng(n).integers(0, jc.vocab, (1, n)).astype(np.int32)
    jfull = np.asarray(jax.jit(lambda p, t: jlm.forward(jc, p, t)[0][:, -1])(jp, tok))
    _, cache = jax.jit(lambda p, t, c: jlm.prefill(jc, p, t, c))(
        jp, tok[:, : n - 1], jlm.init_cache(jc, 1, n + 4))
    jdec = np.asarray(jax.jit(lambda p, t, c: jlm.decode_step(jc, p, t, jnp.int32(n - 1), c)[0])(
        jp, tok[:, n - 1:], cache))[:, 0]
    tt = torch.from_numpy(tok)
    with torch.inference_mode():
        tfull = tlm.forward(tc, tp, tt)[0][:, -1].float().numpy()
        _, tcache = tlm.prefill(tc, tp, tt[:, : n - 1], tlm.init_cache(tc, 1, n + 4, "cpu"))
        tdec = tlm.decode_step(tc, tp, tt[:, n - 1:], n - 1, tcache)[0][:, 0].float().numpy()
    ref_gap = float(np.abs(jdec - jfull).max())
    port_gap = float(np.abs(tdec - tfull).max())
    assert ref_gap > 0 and 0.5 <= port_gap / ref_gap <= 2.0, (ref_gap, port_gap)
    for dec, full in ((jdec, jfull), (tdec, tfull)):
        np.testing.assert_allclose(dec, full, rtol=0.05, atol=0.05)
