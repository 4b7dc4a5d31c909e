"""The lockstep batch of the port (``init_batch``, ``run_batch``) against the
JAX package's and against the port's own sequential runs, on the CPU.

``init_batch`` stacks the per-seed states along a leading axis with the
geometry of ``seeds[0]``; ``run_batch`` runs all seeds as one batch, the
flat tick under ``torch.func.vmap`` with each hot-path kernel a custom op
whose batching rule runs the plain version seed by seed here. Fed the JAX
engine's draws (``JaxTape``), it must equal the reference's ``run_batch``
(one ``jax.vmap``'d scan) on every metric, ``lat_hist`` and the
``TS_FIELDS`` series; fed the port's own generators, each seed must equal
its sequential run bit for bit, final state included. No op of the batched
tick may fall back to functorch's per-sample loop.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch
from _torch_parity import (
    JaxTape,
    assert_outputs_equal,
    first_divergence,
    jax_state_to_numpy,
    port_config,
)

from repro.core import LaminarConfig, LaminarEngine, MemoryConfig
from repro_torch.core.draws import BatchDraws
from repro_torch.core.engine import LaminarEngine as TorchEngine
from repro_torch.core.engine import make_step, seed_state
from repro_torch.core.state import state_to_numpy
from repro_torch.kernel_bench import batched_inputs
from repro_torch.kernels import ENTRIES, LOCKSTEP
from repro_torch.kernels.bitmap_fit import bitmap_fit_rounds
from repro_torch.kernels.bitmap_fit.ops import bitmap_fit_rounds_op
from repro_torch.kernels.node_view import node_view
from repro_torch.kernels.node_view.ops import node_view_op
from repro_torch.kernels.survival_scan import survival_scan
from repro_torch.kernels.survival_scan.ops import survival_scan_op
from repro_torch.kernels.utility_topk import utility_topk_address
from repro_torch.kernels.utility_topk.ops import utility_topk_address_op
from repro_torch.kernels.zone_aggregate import zone_aggregate_members
from repro_torch.kernels.zone_aggregate.ops import zone_aggregate_members_op
from repro_torch.workloads import SCENARIOS as T_SCENARIOS

# tests/test_torch_engine.py's EXP5 (memory dynamics on), cut to 60 ms
EXP5 = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
                     horizon_ms=60.0, rho=0.8, memory=MemoryConfig(enabled=True))
SEEDS = [0, 5, 9]
# the fields tests/test_hotpath.py holds equal across a batch
GEOMETRY = ("zstart", "zcount", "zmember", "zmask", "free", "free0", "node_up", "down_until",
            "rigid_mem")


@pytest.fixture(scope="module")
def fallback_is_an_error():
    """functorch's per-sample fallback warns (when asked to) where an op has
    no batching rule; here that warning is an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def _equal_outputs(want: dict, got: dict) -> None:
    assert first_divergence(want, got) is None, first_divergence(want, got)
    assert_outputs_equal(want, got)


def test_init_batch_matches_reference():
    """Field by field, seed by seed, the reference's ``init_batch``; its
    ``key`` and ``sched_key`` have no counterpart (the port's randomness is
    in each seed's draws, not in the state)."""
    jsb, jlam = LaminarEngine(EXP5).init_batch(SEEDS)
    sb, lam = TorchEngine(port_config(EXP5), device="cpu").init_batch(SEEDS)
    assert lam == jlam
    want = jax_state_to_numpy(jsb)
    assert {"key", "sched_key"} <= set(want) and not {"key", "sched_key"} & set(sb._fields)
    for i in range(len(SEEDS)):
        got = state_to_numpy(seed_state(sb, i))
        for f, g in got.items():
            if f == "metrics":
                for m, v in g.items():
                    np.testing.assert_array_equal(v, want["metrics"][m][i], err_msg=m)
            else:
                np.testing.assert_array_equal(g, want[f][i], err_msg=f)
                assert g.dtype == want[f].dtype, f


def test_init_batch_shares_geometry_in_real_copies():
    sb, _ = TorchEngine(port_config(EXP5), device="cpu").init_batch(SEEDS)
    for f in GEOMETRY:
        x = getattr(sb, f)
        for i in range(1, len(SEEDS)):
            assert torch.equal(x[i], x[0]), f
    for x in sb:  # every row its own memory: the tick writes
        for leaf in (x if isinstance(x, tuple) else (x,)):
            assert leaf.shape[0] == len(SEEDS) and 0 not in leaf.stride()[:1]


@functools.lru_cache(maxsize=None)
def _tapes(seeds: tuple) -> list:
    """The JAX engine's draws of each seed of a batch (``lam`` and zones
    from ``seeds[0]``, as its ``run_batch``); Airlock changes neither, so
    both cases share them."""
    s0, lam = LaminarEngine(EXP5).init(seeds[0])
    return [JaxTape(EXP5, lam, len(s0.zstart), seed=sd, num_ticks=EXP5.num_ticks) for sd in seeds]


@pytest.mark.parametrize("airlock", [False, True], ids=["oom", "airlock"])
def test_run_batch_matches_reference(airlock, fallback_is_an_error):
    cfg = dataclasses.replace(EXP5, airlock=airlock)
    seeds = SEEDS[:2]
    want = LaminarEngine(cfg).run_batch(seeds)
    eng = TorchEngine(port_config(cfg), device="cpu")
    got = eng.run_batch(seeds, draws=_tapes(tuple(seeds)))
    assert [o["seed"] for o in got] == seeds
    for a, b in zip(want, got):
        _equal_outputs(a, b)
    assert want[0]["arrived"] != want[1]["arrived"]
    if airlock:
        assert sum(o["suspended_cnt"] for o in got) > 0
    else:
        assert sum(o["oom_kill_l"] + o["oom_kill_f"] for o in got) > 0


def _sequential(eng, seeds, ticks, scenario=None):
    """Each seed alone from ``seeds[0]``'s initial state, with the seed's
    own generator: (final states, summaries)."""
    s0, lam = eng.init(seeds[0])
    finals, outs = [], []
    for sd in seeds:
        final, ts = eng.simulate(s0, eng.draws(lam, s0.zstart.shape[0], sd, scenario), ticks,
                                 scenario)
        finals.append(final)
        outs.append(eng._summary(final, ts.numpy(), lam, sd))
    return finals, outs


@pytest.mark.parametrize("scenario", ["stationary", "storm"])
def test_lockstep_equals_sequential(scenario, fallback_is_an_error):
    """Bit for bit, final states included, with Airlock on; storm brings
    the disruption stage and its eviction rows into the batched tick."""
    cfg = dataclasses.replace(port_config(EXP5), airlock=True)
    eng = TorchEngine(cfg, device="cpu")
    sc = T_SCENARIOS[scenario]
    ticks, seeds = 80, SEEDS[1:]
    sb, lam = eng.init_batch(seeds)
    draws = BatchDraws([eng.draws(lam, sb.zstart.shape[1], sd, sc) for sd in seeds])
    final, ts = eng.simulate_batch(sb, draws, ticks, sc)
    assert ts.shape == (len(seeds), ticks, 11)
    finals, outs = _sequential(eng, seeds, ticks, sc)
    for i, (f, want) in enumerate(zip(finals, outs)):
        _equal_outputs(want, eng._summary(seed_state(final, i), ts[i].numpy(), lam, seeds[i]))
        a, b = state_to_numpy(f), state_to_numpy(seed_state(final, i))
        for k in a:
            if k == "metrics":
                for m in a[k]:
                    np.testing.assert_array_equal(a[k][m], b[k][m], err_msg=m)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if scenario == "storm":
        assert sum(o["node_failures"] for o in outs) > 0


def test_batch_of_one_equals_run():
    eng = TorchEngine(port_config(EXP5), device="cpu")
    (got,) = eng.run_batch([7], num_ticks=40)
    want = eng.run(seed=7, num_ticks=40)
    assert got.pop("seed") == 7
    _equal_outputs(want, got)


def test_batched_tick_has_no_fallback(fallback_is_an_error):
    """Every op of the batched tick has a batching rule, with disruption and
    kernel OOM on too (the fixture makes a fallback warning an error)."""
    for airlock, sc in ((False, "churn"), (True, "flash")):
        cfg = dataclasses.replace(port_config(EXP5), airlock=airlock, scenario=T_SCENARIOS[sc])
        eng = TorchEngine(cfg, device="cpu")
        sb, lam = eng.init_batch([1, 2])
        draws = BatchDraws([eng.draws(lam, sb.zstart.shape[1], sd) for sd in (1, 2)])
        step = make_step(cfg)
        for t in range(3):
            d = draws.tick(t)
            sb, _ = torch.func.vmap(step, in_dims=(0, BatchDraws.in_dims(d)))(sb, d)
        assert int(sb.t[0]) == 3


OPS = {
    "bitmap_fit_rounds": bitmap_fit_rounds_op,
    "utility_topk_address": utility_topk_address_op,
    "zone_aggregate_members": zone_aggregate_members_op,
    "survival_scan": survival_scan_op,
    "node_view": node_view_op,
}


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("entry", sorted(OPS))
def test_batching_rule_is_the_plain_version_seed_by_seed(entry, fallback_is_an_error):
    """On the CPU each custom op under ``vmap`` and its wrapper given the
    seed axis both equal the wrapper applied seed by seed, for seeds whose
    inputs differ (three seeds; survival_scan with Airlock off too)."""
    assert OPS[entry] is ENTRIES[entry].op
    wrapper = ENTRIES[entry].wrapper
    for airlock in ((True, False) if entry == "survival_scan" else (True,)):
        args, kw = batched_inputs(3, seed=4, airlock=airlock)[entry]
        want = [wrapper(*(a[i] if isinstance(a, torch.Tensor) else a for a in args), **kw)
                for i in range(3)]
        want = tuple(torch.stack(o) for o in zip(*want))
        _equal(wrapper(*args, **kw), want)
        # the op under vmap, the seed axis moved to dim 1 of the first input
        moved = (args[0].movedim(0, 1), *args[1:])
        dims = (1,) + (0,) * (len(args) - 1)
        got = torch.func.vmap(lambda *a: OPS[entry](*a, **kw), in_dims=dims)(*moved)
        _equal(got, want)
        assert all(torch.equal(x, y) for x, y in zip(OPS[entry](*(a[1] for a in args), **kw),
                                                      (w[1] for w in want)))


def test_batching_rule_broadcasts_an_unmapped_input():
    """An input ``vmap`` does not map is every seed's: the rule gives the
    entry a copy a seed."""
    args, kw = batched_inputs(2, seed=6)["bitmap_fit_rounds"]
    shared = args[5][0]  # seed 0's words for both seeds
    dims = (0, 0, 0, 0, 0, None, 0)
    got = torch.func.vmap(lambda *a: bitmap_fit_rounds_op(*a, **kw), in_dims=dims)(
        *args[:5], shared, args[6])
    want = bitmap_fit_rounds(*args[:5], torch.stack([shared, shared]), args[6], **kw)
    _equal(got, want)


def test_batched_wrappers_count_no_cpu_launch():
    for name in LOCKSTEP:
        ENTRIES[name].wrapper.launches = 0
    for name, (args, kw) in batched_inputs(2).items():
        ENTRIES[name].wrapper(*args, **kw)
    assert {name: ENTRIES[name].wrapper.launches for name in LOCKSTEP} == dict.fromkeys(
        LOCKSTEP, 0)
    assert bitmap_fit_rounds is ENTRIES["bitmap_fit_rounds"].wrapper
    assert survival_scan is ENTRIES["survival_scan"].wrapper
    assert utility_topk_address is ENTRIES["utility_topk_address"].wrapper
    assert zone_aggregate_members is ENTRIES["zone_aggregate_members"].wrapper
    assert node_view is ENTRIES["node_view"].wrapper


def test_address_accumulators_are_a_region_a_stream_and_capture():
    """The address kernel's count accumulators: one region of the device's
    pool for each stream and each graph capture (two streams interleaved
    never share one), the same region again for the same key, and a
    refusal once the pool is spent."""
    from repro_torch.kernels.utility_topk import ops as topk_ops
    from repro_torch.kernels.utility_topk import plan as topk_plan

    saved = dict(topk_ops._acc_regions)
    topk_ops._acc_regions.clear()
    try:
        acc = topk_ops.accumulator
        a, b = acc(0, 0x10, 0, 4), acc(0, 0x20, 0, 4)  # streams A and B
        assert (a, b) == (0, 16)
        assert (acc(0, 0x10, 0, 4), acc(0, 0x20, 0, 4)) == (a, b)
        assert acc(0, 0x20, 7, 4) == 32  # a graph captured on stream B
        assert acc(0, 0x10, 0, 1) == 48  # stream A at another seed count
        assert acc(1, 0x10, 0, 4) == 0  # another device: its own pool
        with pytest.raises(RuntimeError, match="no count accumulator left"):
            acc(0, 0x30, 0, topk_plan.ACC_POOL_WORDS // 4)
        assert acc(0, 0x10, 0, 4) == a
    finally:
        topk_ops._acc_regions.clear()
        topk_ops._acc_regions.update(saved)


@pytest.mark.parametrize("entry", sorted(OPS))
def test_batched_plan_is_the_plan_with_a_seed_axis(entry):
    """One plan builder an entry: given the seed axis, it gives the plan
    without it with ``seeds`` set on the launch and every output with the
    leading axis."""
    plan_for = ENTRIES[entry].plan
    args, kw = batched_inputs(3, seed=4)[entry]
    one = plan_for(*(a[0] if isinstance(a, torch.Tensor) else a for a in args), **kw)
    many = plan_for(*args, **kw)
    assert (one.entry, one.seeds, one.lead) == (entry, 0, ())
    assert (many.entry, many.seeds, many.lead) == (entry, 3, (3,))
    assert many.launches == tuple(dataclasses.replace(L, seeds=3) for L in one.launches)
    assert [o.shape for o in many.outputs] == [(3, *o.shape) for o in one.outputs]
    assert many.scratch_words == 3 * (many.scratch_words // 3) >= 3 * one.scratch_words


def test_noise_scale_is_the_float32_product():
    """The ambient noise's scale, computed once outside the tick, equals the
    float32 product numpy gives, bit for bit, over 10 000 configurations."""
    from repro_torch.core.airlock import noise_scale
    from repro_torch.core.config import MemoryConfig as TorchMemoryConfig

    rng = np.random.default_rng(0)
    for decay, sigma in zip(rng.uniform(0.0, 1.0, 10_000), rng.uniform(0.0, 2.0, 10_000)):
        decay, sigma = float(decay), float(sigma)
        want = float(np.sqrt(np.float32(1 - decay**2)) * np.float32(sigma))
        got = noise_scale(TorchMemoryConfig(ambient_decay=decay, noise_sigma=sigma))
        assert got == want, (decay, sigma)


def test_refusals():
    eng = TorchEngine(port_config(EXP5), device="cpu")
    with pytest.raises(ValueError, match="run_batch needs at least one seed"):
        eng.run_batch([])
    with pytest.raises(ValueError, match="init_batch needs at least one seed"):
        eng.init_batch([])
    s0, lam = eng.init(0)
    draws = [eng.draws(lam, s0.zstart.shape[0], sd) for sd in (0, 1)]
    with pytest.raises(ValueError, match="draws for"):
        eng.run_batch([0, 1, 2], num_ticks=2, draws=draws)
    with pytest.raises(ValueError, match="scenario"):
        eng.run_batch([0, 1], num_ticks=2, scenario=T_SCENARIOS["storm"], draws=draws)
    storm = eng.draws(lam, s0.zstart.shape[0], 2, T_SCENARIOS["storm"])
    with pytest.raises(ValueError, match="different scenarios"):
        BatchDraws([draws[0], storm])
    with pytest.raises(ValueError, match="at least one provider"):
        BatchDraws([])
