"""The port's configuration, state and bitmap substrate against the JAX package.

  * every config dataclass: the same fields and defaults (``use_pallas``
    aside, which the port replaces with dispatch by device);
  * ``init_state``: every field equal, the PRNG keys aside;
  * the bitmap substrate (int32 bit patterns here, uint32 words there):
    exactly equal on random bit planes;
  * ``state_from_numpy`` / ``state_to_numpy``: a lossless round trip of a
    JAX state;
  * the engine's device rule: CUDA by default, raising without it;
  * ``scatter_sum``: the spare-row sum bit for bit, and no hot row in any
    scatter-add of a tick.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_state_to_numpy, port_config
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import bitmap as jbitmap
from repro.core import config as jconfig
from repro.core import state as jstate
from repro.workloads import SCENARIOS as J_SCENARIOS
from repro_torch.analysis import trace_audit
from repro_torch.core import bitmap as tbitmap
from repro_torch.core import config as tconfig
from repro_torch.core import state as tstate
from repro_torch.core.draws import ArrayDraws, TorchDraws
from repro_torch.core.engine import LaminarEngine, make_step
from repro_torch.workloads import SCENARIOS as T_SCENARIOS

T = torch.from_numpy


def _fields(obj):
    return {f.name: f.default if f.default is not dataclasses.MISSING else f.default_factory()
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize(
    "name", ["LaminarConfig", "WorkloadConfig", "MemoryConfig", "BaselineConfig"]
)
def test_config_defaults_equal(name):
    want = _fields(getattr(jconfig, name))
    got = _fields(getattr(tconfig, name))
    want.pop("use_pallas", None)
    assert set(got) == set(want)
    for k in want:
        if k == "scenario":
            assert got[k].signature() == want[k].signature()
        elif dataclasses.is_dataclass(want[k]):
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k]), k
        else:
            assert got[k] == want[k], k


def test_config_constants_and_properties():
    assert tconfig.NUM_TIERS == jconfig.NUM_TIERS
    assert tconfig.TIER_NAMES == jconfig.TIER_NAMES
    assert tconfig.TIER_MIXES == jconfig.TIER_MIXES
    for jc in (jconfig.LaminarConfig(), jconfig.LaminarConfig(num_nodes=72, zone_size=32)):
        tc = port_config(jc)
        assert (tc.num_ticks, tc.num_zones, tc.ticks(7.3)) == (jc.num_ticks, jc.num_zones, jc.ticks(7.3))
        assert tc.arrival_rate_per_s(1234.0) == jc.arrival_rate_per_s(1234.0)
    assert set(T_SCENARIOS) == set(J_SCENARIOS)
    for k in J_SCENARIOS:
        assert T_SCENARIOS[k].signature() == J_SCENARIOS[k].signature()


SMALL = jconfig.LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024,
                              max_arrivals_per_tick=64)


@pytest.mark.parametrize(
    "cfg,seed",
    [(SMALL, 0), (SMALL, 3), (jconfig.LaminarConfig(num_nodes=500, zone_size=64,
                                                    probe_capacity=4096), 1)],
)
def test_init_state_field_for_field(cfg, seed):
    want = jax_state_to_numpy(jstate.init_state(cfg, seed))
    got = tstate.state_to_numpy(tstate.init_state(port_config(cfg), seed, "cpu"))
    assert set(got) == set(want) - {"key", "sched_key"}
    for f in got:
        if f == "metrics":
            for g in want[f]:
                np.testing.assert_array_equal(got[f][g], want[f][g], err_msg=g)
                assert got[f][g].dtype == want[f][g].dtype, g
            continue
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert got[f].dtype == want[f].dtype, f


def test_state_round_trip():
    """A JAX state with every word bit pattern in use survives the trip."""
    s = jstate.init_state(SMALL, 0)
    rng = np.random.default_rng(0)
    P, N = SMALL.probe_capacity, SMALL.num_nodes
    s = s._replace(
        alloc=jnp.asarray(rng.integers(0, 2**32, (P, 2), dtype=np.uint32)),
        free=jnp.asarray(np.full((N, 2), 0xFFFFFFFF, np.uint32)),
        mem=jnp.asarray(rng.uniform(size=P).astype(np.float32)),
        migrating=jnp.asarray(rng.uniform(size=P) < 0.5),
        t=jnp.asarray(17, jnp.int32),
    )
    d = jax_state_to_numpy(s)
    ts = tstate.state_from_numpy(d, "cpu")
    assert ts.free.dtype == torch.int32 and int(ts.free[0, 0]) == -1
    back = tstate.state_to_numpy(ts)
    for f in back:
        if f != "metrics":
            np.testing.assert_array_equal(back[f], d[f], err_msg=f)
            assert back[f].dtype == d[f].dtype, f


# ---------------------------------------------------------------------------
# bitmap substrate
# ---------------------------------------------------------------------------


def _planes(seed, n=64, atoms=64, p=0.6):
    return np.random.default_rng(seed).uniform(size=(n, atoms)) < p


@pytest.mark.parametrize("W", [1, 2, 3])
def test_pack_unpack_popcount(W):
    words = np.random.default_rng(W).integers(0, 2**32, (50, W), dtype=np.uint32)
    tw = T(words.view(np.int32))
    bits = tbitmap.unpack_bits(tw, 32 * W)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbitmap.unpack_bits(jnp.asarray(words), 32 * W)))
    np.testing.assert_array_equal(tbitmap.pack_bits(bits).numpy().view(np.uint32), words)
    np.testing.assert_array_equal(
        tbitmap.popcount_words(tw).numpy(), np.asarray(jbitmap.popcount_words(jnp.asarray(words)))
    )
    np.testing.assert_array_equal(
        tbitmap.free_atoms(tw).numpy(), np.asarray(jbitmap.free_atoms(jnp.asarray(words)))
    )
    # a plane whose width is not a multiple of 32 packs with zero padding
    np.testing.assert_array_equal(
        tbitmap.pack_bits(bits[:, :40]).numpy().view(np.uint32),
        np.asarray(jbitmap.pack_bits(jnp.asarray(bits[:, :40].numpy()))),
    )


def test_shr_logical():
    w = T(np.array([-1, -2**31, 5], np.int32))
    np.testing.assert_array_equal(
        tbitmap.shr_logical(w, 1).numpy(), [0x7FFFFFFF, 0x40000000, 2]
    )
    np.testing.assert_array_equal(tbitmap.shr_logical(w, 32).numpy(), [0, 0, 0])


@pytest.mark.parametrize("seed", [0, 1])
def test_run_analysis(seed):
    bits = _planes(seed)
    jb, tb = jnp.asarray(bits), T(bits)
    for name in ("run_lengths", "max_run", "run_totals"):
        np.testing.assert_array_equal(
            getattr(tbitmap, name)(tb).numpy(), np.asarray(getattr(jbitmap, name)(jb)), err_msg=name
        )
    words = np.random.default_rng(seed).integers(0, 2**32, 200, dtype=np.uint32)
    m = np.random.default_rng(seed + 9).integers(0, 33, 200).astype(np.int32)
    np.testing.assert_array_equal(
        tbitmap.contiguous_feasible_words(T(words.view(np.int32)), T(m)).numpy(),
        np.asarray(jbitmap.contiguous_feasible_words(jnp.asarray(words), jnp.asarray(m))),
    )


@pytest.mark.parametrize("policy", ["first", "best"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alloc_for_class(policy, seed):
    rng = np.random.default_rng(seed)
    bits = _planes(seed, p=0.5 + 0.1 * seed)
    m = rng.integers(0, 13, 64).astype(np.int32)
    c = rng.integers(0, 2, 64).astype(bool)
    ja, jf = jbitmap.alloc_for_class(jnp.asarray(bits), jnp.asarray(m), jnp.asarray(c), policy)
    ta, tf = tbitmap.alloc_for_class(T(bits), T(m), T(c), policy)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(
        tbitmap.feasible_for_class(T(bits.sum(-1)), tbitmap.max_run(T(bits)), T(m), T(c)).numpy(),
        np.asarray(jbitmap.feasible_for_class(
            jnp.asarray(bits.sum(-1)), jbitmap.max_run(jnp.asarray(bits)), jnp.asarray(m), jnp.asarray(c))),
    )


# ---------------------------------------------------------------------------
# host-side helpers and the device rule
# ---------------------------------------------------------------------------


def test_latency_bucket_and_hist_quantile():
    lat = np.arange(0, 4000, dtype=np.float32) * 0.5
    np.testing.assert_array_equal(
        tstate.latency_bucket(T(lat)).numpy(), np.asarray(jax.jit(jstate.latency_bucket)(lat))
    )
    hist = np.random.default_rng(0).integers(0, 50, 64)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert tstate.hist_quantile(hist, q) == jstate.hist_quantile(hist, q)
    assert tstate.hist_quantile(np.zeros(64), 0.5) == 0.0


def test_engine_latency_bucket_equals_jitted_jax_at_every_latency():
    """Every whole-tick latency of 0 .. 2**18 ticks at dt_ms 0.5, formed as
    the arbiter forms it (``(t - arrival)`` as float32 times ``dt_ms``),
    through the jitted reference and the engine's ``latency_bucket``: equal,
    the exactly-4096- and 16384-tick latencies included. The baselines use
    the same function."""
    from repro_torch.core.baselines import common as tcommon

    dt_ms = 0.5
    t = np.int32(1 << 18)
    arrival = np.arange((1 << 18) + 1, dtype=np.int32)
    want = np.asarray(jax.jit(
        lambda a: jstate.latency_bucket((t - a).astype(jnp.float32) * dt_ms))(arrival))
    got = tstate.latency_bucket((torch.tensor(t) - T(arrival)).to(torch.float32) * dt_ms)
    np.testing.assert_array_equal(want, got.numpy())
    assert tcommon.latency_bucket is tstate.latency_bucket


def test_tier_counts():
    rng = np.random.default_rng(4)
    tier = rng.integers(0, 3, 500).astype(np.int32)
    mask = rng.uniform(size=500) < 0.4
    np.testing.assert_array_equal(
        tstate.tier_counts(T(tier), T(mask)).numpy(),
        np.asarray(jstate.tier_counts(jnp.asarray(tier), jnp.asarray(mask))),
    )


def _spare_row_sum(rows, tgt, valid, upd):
    """The one-spare-row scatter-add: every dropped slot adds a zero into
    row ``rows``, which is cut off."""
    keep = valid.reshape(valid.shape + (1,) * (upd.dim() - 1))
    acc = upd.new_zeros((rows + 1,) + tuple(upd.shape[1:]))
    acc.index_add_(0, torch.where(valid, tgt, rows).long(), torch.where(keep, upd, 0))
    return acc[:rows]


@pytest.mark.parametrize("batched", [False, True], ids=["per_seed", "vmap"])
@pytest.mark.parametrize("rows", [5, 64], ids=["narrow", "node_wide"])
@pytest.mark.parametrize("words", [1, 2])
def test_scatter_sum_equals_the_spare_row(words, rows, batched):
    """``scatter_sum`` (a spare row of its own for each dropped slot) gives
    the spare-row sum bit for bit: random int32 bit patterns, one- and
    two-word rows, 5 and 64 output rows, masks, nodes of -1 and masked rows
    whose node is -1; under ``torch.func.vmap`` over 3 seeds it equals the
    per-seed calls."""
    gen = torch.Generator().manual_seed(100 * words + rows)
    B, P = 3, 512
    bits = torch.randint(-(2**31), 2**31, (B, P, words), generator=gen,
                         dtype=torch.int64).to(torch.int32)
    if words == 1:
        bits = bits[..., 0]
    node = torch.randint(-1, rows, (B, P), generator=gen, dtype=torch.int32)
    mask = torch.rand((B, P), generator=gen) < 0.6
    valid = mask & (node >= 0)
    assert (mask & (node < 0)).any() and (~mask & (node >= 0)).any()
    want = torch.stack([_spare_row_sum(rows, node[i], valid[i], bits[i]) for i in range(B)])
    per_seed = torch.stack([tstate.scatter_sum(rows, node[i], valid[i], bits[i])
                            for i in range(B)])
    got = per_seed
    if batched:
        got = torch.func.vmap(lambda t, v, u: tstate.scatter_sum(rows, t, v, u))(node, valid, bits)
        assert torch.equal(got, per_seed)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


class _ZeroRowsAtOneIndex(TorchDispatchMode):
    """For each ``index_add_`` dispatched while active: the rows it adds
    into, its slots, and the most slots whose update is all zeros that it
    sends to one index."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.index_add_, torch.ops.aten.index_add):
            out, _, index, src = args[:4]
            zero = (src.reshape(src.shape[0], -1) == 0).all(dim=1)
            hits = torch.bincount(index[zero], minlength=out.shape[0])
            self.calls.append((out.shape[0], index.shape[0], int(hits.max())))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("scenario", ["stationary", "storm"])
def test_no_scatter_add_of_the_tick_has_a_hot_row(scenario):
    """No ``index_add_`` of a tick sends more slots of zeros to one index
    than ceil(P / R), R the rows it adds into: on the card such slots
    serialise their atomics on that address. One tick with real values
    (after 40 ticks) at the trace audit's geometry, 64 nodes and 256 slots.
    The spare-row formulation fails this: its one spare row receives almost
    every slot of most calls."""
    cfg = dataclasses.replace(trace_audit.audit_config(), scenario=T_SCENARIOS[scenario])
    eng = LaminarEngine(cfg, device="cpu")
    s, lam = eng.init(0)
    draws = eng.draws(lam, s.zstart.shape[0], 0)
    s, _ = eng.simulate(s, draws, 40)
    with _ZeroRowsAtOneIndex() as rec:
        make_step(cfg)(s, draws.tick(40))
    assert len(rec.calls) >= 14
    hot = [(R, P, most) for R, P, most in rec.calls if most > -(-P // R)]
    assert hot == []


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        LaminarEngine(cfg)
    assert LaminarEngine(cfg, device="cpu").device.type == "cpu"


def test_engine_rejects_unported_scenarios():
    """Every scenario preset runs now (the engine reads it from
    ``cfg.scenario``); what the engine still rejects is generator draws made
    for another scenario, recorded draws without the disruption values the
    scenario needs, and an empty seed list."""
    cfg = port_config(SMALL)
    s, lam = LaminarEngine(cfg, device="cpu").init(0)
    stationary = TorchDraws(cfg, lam, s.zstart.shape[0], seed=0, device="cpu")
    for name in ("bursty", "churn"):
        eng = LaminarEngine(dataclasses.replace(cfg, scenario=T_SCENARIOS[name]), device="cpu")
        assert eng.run(seed=0, num_ticks=2)["arrived"] >= 0
        with pytest.raises(ValueError, match="scenario 'stationary'"):
            eng.run(seed=0, num_ticks=1, draws=stationary)
    recorded = ArrayDraws({k: v.numpy()[None] for k, v in stationary.tick(0)._asdict().items()
                           if v is not None})
    with pytest.raises(ValueError, match="disruption"):
        eng.run(seed=0, num_ticks=1, draws=recorded)
    with pytest.raises(ValueError):
        eng.run_batch([])
