"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU, on ``benchmarks/bench_moe_router.py``'s traffic at
the smoke width (olmoe-1b-7b reduced: d_model 64, 4 experts, top-2):
2048 tokens ``skew * base + (1 - skew) * noise`` in bfloat16, skews 0, 0.5
and 0.9, capacity factors 0.5, 1.0 and 1.5, both routers.

The routing is integer work on float32 router logits, which the port forms
as the reference does (the same float32 product at this width, XLA's ``log2``
rounding in the laminar router's heat term), so it is held exactly: every
round's chosen experts and kept flags, ``moe_dropped_slots`` and
``moe_load``. The output goes through bfloat16 expert FFNs whose SiLU
rounds each step as XLA does (``common.silu``): within 0.00081 of its
largest magnitude over the sweep (0.0162 before that rounding, with
``F.silu``). Tolerance ``BF16_TOL`` (2**-9) of the largest magnitude.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_moe_picks, port_arch

from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe
from repro_torch.models import bridge
from repro_torch.models import moe as tmoe

BF16_TOL = 2.0**-9
N_TOK = 2048


def _cfg(router, capacity, bounces=2, assoc=False):
    cfg = jget_smoke("olmoe-1b-7b")
    return dataclasses.replace(
        cfg, moe_assoc_scan=assoc,
        moe=dataclasses.replace(cfg.moe, router=router, capacity_factor=capacity,
                                laminar_bounces=bounces),
    )


def _traffic(skew, d, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((1, 1, d)).astype(np.float32)
    noise = rng.standard_normal((1, N_TOK, d)).astype(np.float32)
    return np.asarray(jnp.asarray(skew * base + (1 - skew) * noise).astype(jnp.bfloat16))


def _params(cfg):
    jp = jax.jit(lambda k: jmoe.init_moe_params(k, cfg))(jax.random.PRNGKey(0))
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _port_picks(tp, tc, x):
    picks, _, _, _ = tmoe.route(tp, tc, x.reshape(-1, x.shape[-1]))
    return (np.stack([p.expert.numpy() for p in picks]),
            np.stack([p.kept.numpy() for p in picks]))


@pytest.mark.parametrize("router", ["topk", "laminar"])
@pytest.mark.parametrize("capacity", [0.5, 1.0, 1.5])
@pytest.mark.parametrize("skew", [0.0, 0.5, 0.9])
def test_moe_matches_jax(router, capacity, skew):
    jc = _cfg(router, capacity)
    tc = port_arch(jc)
    jp, tp = _params(jc)
    x = _traffic(skew, jc.d_model)
    want, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, jc, x))(jp, jnp.asarray(x))
    got, taux = tmoe.moe_ffn(tp, tc, bridge.tensor_from_numpy(x, "cpu"))

    j_e, j_k = jax_moe_picks(jp, jc, jnp.asarray(x))
    t_e, t_k = _port_picks(tp, tc, bridge.tensor_from_numpy(x, "cpu"))
    np.testing.assert_array_equal(j_e, t_e)
    np.testing.assert_array_equal(j_k, t_k)
    assert int(jaux["moe_dropped_slots"]) == int(taux["moe_dropped_slots"])
    np.testing.assert_array_equal(np.asarray(jaux["moe_load"]), taux["moe_load"].numpy())

    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    w, g = np.asarray(want, np.float32), got.float().numpy()
    assert np.abs(w - g).max() <= BF16_TOL * np.abs(w).max()


def test_drops_where_the_reference_drops():
    """The rows of the sweep the bench reports: top-k drops under skew and a
    small capacity, the laminar router's bounces drop fewer, and an ample
    capacity drops nothing (``tests/test_moe.py``'s claims, on the port)."""
    drops = {}
    for router in ("topk", "laminar"):
        for capacity in (0.5, 4.0):
            tc = port_arch(_cfg(router, capacity, bounces=3))
            _, tp = _params(_cfg(router, capacity, bounces=3))
            x = bridge.tensor_from_numpy(_traffic(0.9, tc.d_model), "cpu")
            drops[router, capacity] = int(tmoe.moe_ffn(tp, tc, x)[1]["moe_dropped_slots"])
    assert drops["topk", 0.5] > drops["laminar", 0.5] > 0
    assert drops["topk", 4.0] == drops["laminar", 4.0] == 0


@pytest.mark.parametrize("router", ["topk", "laminar"])
def test_assoc_scan_equals_cumsum(router):
    """``moe_assoc_scan`` (a log-depth prefix sum) gives the cumsum's
    positions, so the same routing and output bit for bit."""
    jc = _cfg(router, 1.0)
    _, tp = _params(jc)
    x = bridge.tensor_from_numpy(_traffic(0.5, jc.d_model), "cpu")
    a = tmoe.moe_ffn(tp, port_arch(jc), x)
    b = tmoe.moe_ffn(tp, port_arch(dataclasses.replace(jc, moe_assoc_scan=True)), x)
    assert torch.equal(a[0], b[0])
    assert int(a[1]["moe_dropped_slots"]) == int(b[1]["moe_dropped_slots"])
    v = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (1000, 5)).astype(np.int32))
    assert torch.equal(tmoe._prefix_sum(v), torch.cumsum(v, 0, dtype=torch.int32))


def test_capacity_matches_jax():
    for n, cf in ((48, 1.25), (2048, 0.5), (2048, 1.0), (7, 1.5), (100000, 2.0)):
        mc = _cfg("topk", cf).moe
        assert tmoe._capacity(port_arch(_cfg("topk", cf)).moe, n) == jmoe._capacity(mc, n)


def test_argmax_takes_the_lowest_index_as_jnp_argmax():
    """The router's argmax on ties and on rows every expert of which is
    spent (all -inf): the lowest index, as ``jnp.argmax`` (the card test
    holds CUDA to the CPU on the same rows)."""
    rows = np.array([[1.0, 3.0, 3.0, 0.0], [-np.inf] * 4, [2.0, 2.0, 2.0, 2.0],
                     [-np.inf, -np.inf, 5.0, 5.0], [0.0, -0.0, 0.0, -1.0]], np.float32)
    np.testing.assert_array_equal(torch.argmax(torch.from_numpy(rows), dim=-1).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1)))
