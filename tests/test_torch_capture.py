"""The compiled run of the port (``repro_torch.core.scan``) on the CPU.

On CUDA, ``simulate``, ``simulate_batch`` and the baselines' ``simulate``
capture one tick as a CUDA graph and replay it; on the CPU the same in-place
body runs in a loop. Here, on the CPU:

  * that body equals ``make_step`` driven by hand, bit for bit: the series,
    every leaf of the final state, and where the provider's generator ends;
  * the draws read the tick from a device tensor and give, at every tick of
    a horizon that crosses mmpp segments, a diurnal period and the flash
    spike, what the Python tick gives;
  * a tick's ops and their non-tensor arguments do not depend on the tick,
    so no host value of ``t`` is frozen into a captured graph (the
    counterpart of the reference tracing its step once);
  * a run returns the caller's own state, which a later run leaves alone;
  * the address kernel's accumulator regions are given back and reused.

The parity tests against the JAX package (``test_torch_engine.py``,
``test_torch_batch.py``, ``test_torch_baselines_parity.py`` and the
scenario files) run through the same body.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.analysis.trace_audit import recorded
from repro_torch.core import BaselineConfig, LaminarConfig, LaminarEngine, MemoryConfig
from repro_torch.core.baselines import common as C
from repro_torch.core.baselines import flux_like, ray_like, slurm_like
from repro_torch.core.baselines.draws import TorchBaselineDraws
from repro_torch.core.draws import BatchDraws, TorchDraws
from repro_torch.core.engine import make_step
from repro_torch.core.scan import scan, watching
from repro_torch.workloads import SCENARIOS

SMALL = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
                      horizon_ms=40.0, rho=0.8, memory=MemoryConfig(enabled=True))
TICKS = 80
CAP = 1 << 12
BASELINES = {"slurm": slurm_like, "ray": ray_like, "flux": flux_like}
# a horizon past a diurnal period (800 ticks), the flash spike (ticks 0-39 of
# every 600) and nine mmpp segments (100 ticks each)
HORIZON = 900


def _eager(step, s, draws, ticks):
    rows = []
    for t in range(ticks):
        s, y = step(s, draws.tick(t))
        rows.append(y)
    return s, torch.stack(rows)


def _bits(s):
    return [(tuple(x.shape), x.dtype, x.numpy().tobytes()) for x in pytree.tree_flatten(s)[0]]


def _config(case):
    airlock = case != "kernel-oom"
    scenario = SCENARIOS[case] if case in SCENARIOS else SCENARIOS["stationary"]
    return dataclasses.replace(SMALL, airlock=airlock, scenario=scenario)


@pytest.mark.parametrize("case", ["kernel-oom", "airlock", "storm", "diurnal"])
def test_flat_body_equals_make_step(case):
    cfg = _config(case)
    eng = LaminarEngine(cfg, device="cpu")
    s, lam = eng.init(0)
    a, b = (eng.draws(lam, s.zstart.shape[0], 0) for _ in range(2))
    final, ts = eng.simulate(s, a, TICKS)
    efinal, ets = _eager(make_step(cfg), s, b, TICKS)
    assert torch.equal(ts, ets)
    assert _bits(final) == _bits(efinal)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert int(ts[-1, 1]) > 0


def test_lockstep_body_equals_make_step():
    cfg = _config("airlock")
    eng = LaminarEngine(cfg, device="cpu")
    sb, lam = eng.init_batch([0, 1])

    def draws():
        return BatchDraws([eng.draws(lam, sb.zstart.shape[1], sd) for sd in (0, 1)])

    final, ts = eng.simulate_batch(sb, draws(), TICKS)
    step = make_step(cfg)
    efinal, ets = _eager(lambda s, d: torch.func.vmap(step, in_dims=(0, BatchDraws.in_dims(d)))(
        s, d), sb, draws(), TICKS)
    assert torch.equal(ts, ets.movedim(0, 1))
    assert _bits(final) == _bits(efinal)


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_body_equals_its_step(name):
    mod = BASELINES[name]
    cfg = dataclasses.replace(SMALL, rho=0.9, memory=MemoryConfig(), scenario=SCENARIOS["storm"])
    s, lam = mod.init(cfg, 0, CAP, "cpu")
    step = mod.make_step(cfg, BaselineConfig())
    a, b = (TorchBaselineDraws(name, cfg, lam, CAP, 0, "cpu") for _ in range(2))
    final, ys = C.simulate(step, s, a, TICKS)
    efinal, eys = _eager(step, s, b, TICKS)
    assert torch.equal(ys, eys)
    assert _bits(final) == _bits(efinal)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert int(ys[-1, 1]) > 0


def test_host_filled_draws_equal_make_step():
    """Draws from a provider that does not sample on the state's device
    (here values recorded beforehand) are copied into the body's buffers
    before each tick."""
    from repro_torch.core.draws import ArrayDraws, Draws

    cfg = _config("storm")
    eng = LaminarEngine(cfg, device="cpu")
    s, lam = eng.init(0)
    prov = eng.draws(lam, s.zstart.shape[0], 3)
    ticks = [prov.tick(t) for t in range(TICKS)]
    arrays = {f: np.stack([getattr(d, f).numpy() for d in ticks])
              for f in Draws._fields if getattr(ticks[0], f) is not None}
    final, ts = eng.simulate(s, ArrayDraws(arrays), TICKS)
    efinal, ets = _eager(make_step(cfg), s, ArrayDraws(arrays), TICKS)
    assert torch.equal(ts, ets)
    assert _bits(final) == _bits(efinal)


def _draws_fields(d):
    return [(name, None if x is None else x.numpy().tobytes()) for name, x in zip(d._fields, d)]


@pytest.mark.parametrize("preset", sorted(SCENARIOS))
def test_draws_from_the_device_tick_equal_the_host_tick(preset):
    """Every schedule kind: the provider fed the tick as an int32 tensor
    (its burst table made to cover the horizon first) draws, at every tick,
    what the provider fed the Python int draws; so do the baselines'."""
    cfg = dataclasses.replace(SMALL, scenario=SCENARIOS[preset])
    host = TorchDraws(cfg, 17.5, 2, seed=5, device="cpu")
    dev = TorchDraws(cfg, 17.5, 2, seed=5, device="cpu")
    dev.cover(HORIZON)
    rates = []
    for t in range(HORIZON):
        tt = torch.tensor(t, dtype=torch.int32)
        rates.append(float(dev._rate(tt)))
        assert float(host._rate(t)) == rates[-1], t
        assert _draws_fields(host.tick(t)) == _draws_fields(dev.tick(tt)), t
    if cfg.scenario.schedule.kind != "stationary":
        assert len(set(rates)) > 1  # the horizon crosses the schedule's changes
    for name in sorted(BASELINES):
        host = TorchBaselineDraws(name, cfg, 17.5, 256, seed=5, device="cpu")
        dev = TorchBaselineDraws(name, cfg, 17.5, 256, seed=5, device="cpu")
        dev.cover(HORIZON)
        for t in range(0, HORIZON, 7):  # every 7th tick, the generator between
            assert _draws_fields(host.tick(t)) == _draws_fields(
                dev.tick(torch.tensor(t, dtype=torch.int32))), (name, t)


def _recorded_tick(cfg, t, host_tick=False):
    """The ops of one flat tick with its draws, made at tick ``t`` (an int32
    tensor, or the Python int with ``host_tick``), after a warm-up tick."""
    eng = LaminarEngine(cfg, device="cpu")
    s, lam = eng.init(0)
    prov = eng.draws(lam, s.zstart.shape[0], 0)
    prov.cover(HORIZON)
    step = make_step(cfg)
    tick = t if host_tick else torch.tensor(t, dtype=torch.int32)
    ops, _ = recorded(lambda: lambda: step(s, prov.draw(prov._tick(tick), prov.gen, prov.tables)))
    return [(op.name, op.sig) for op in ops]


@pytest.mark.parametrize("preset", ["storm", "diurnal", "flash"])
def test_tick_ops_do_not_depend_on_the_tick(preset):
    """Ticks 3 (in the flash spike, the first mmpp segment) and 250 (out of
    it, the third segment, another diurnal phase): the same ops with the same
    non-tensor arguments. Built from the Python tick, as the eager draws
    are, the two differ: the test sees a host tick."""
    cfg = _config(preset)
    a = _recorded_tick(cfg, 3)
    assert a == _recorded_tick(cfg, 250)
    assert _recorded_tick(cfg, 3, host_tick=True) != _recorded_tick(cfg, 250, host_tick=True)


def test_a_run_returns_the_callers_own_state():
    """Two runs in a row on one engine: the second (the compiled tick's
    buffers reused) leaves the first's returned state and series as they
    were; the compiled tick is made once."""
    cfg = _config("airlock")
    eng = LaminarEngine(cfg, device="cpu")
    s, lam = eng.init(0)
    first, ts = eng.simulate(s, eng.draws(lam, s.zstart.shape[0], 0), 30)
    kept = _bits(first), ts.clone()
    with watching() as runs:
        again, _ = eng.simulate(first, eng.draws(lam, s.zstart.shape[0], 1), 30)
    assert _bits(first) == kept[0] and torch.equal(ts, kept[1])
    assert _bits(again) != kept[0]
    assert len(eng._compiled) == 1 and runs[0][0] is next(iter(eng._compiled.values()))
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(pytree.tree_flatten(first)[0],
                                                            runs[0][0].bufs))


def test_scan_across_the_series_ring():
    """A run longer than the series ring: every row lands in order."""
    from repro_torch.core.scan import RING

    def step(s, d):
        t = s[0] + 1
        return (t,), torch.stack([t, d.arr_n])

    prov = TorchDraws(SMALL, 5.0, 2, seed=0, device="cpu")
    n = RING + 37
    (final,), ys = scan(step, (torch.zeros((), dtype=torch.int32),), prov, n)
    assert int(final) == n and torch.equal(ys[:, 0], torch.arange(1, n + 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        scan(step, (final,), prov, 0)


def test_accumulator_regions_are_given_back_and_reused(monkeypatch):
    """A capture's regions (those ``owned_regions`` collects; eager keys it
    leaves out) are given back by ``release``; a new key then takes the
    lowest free words, and a key past the pool is still refused."""
    from repro_torch.kernels.utility_topk import ops as topk_ops
    from repro_torch.kernels.utility_topk import plan as topk_plan

    monkeypatch.setattr(topk_ops, "_acc_regions", {})
    monkeypatch.setattr(topk_plan, "ACC_POOL_WORDS", 32)
    acc = topk_ops.accumulator
    assert acc(0, 0x10, 0, 1) == 0
    with topk_ops.owned_regions() as keys:
        assert acc(0, 0x20, 7, 2) == 4  # a graph of two seeds, captured on stream B
        assert acc(0, 0x20, 8, 1) == 12
        assert acc(0, 0x10, 0, 1) == 0  # an eager key seen before: not the capture's
    assert keys == [(0, 0x20, 7, 2), (0, 0x20, 8, 1)]
    assert acc(0, 0x30, 0, 4) == 16
    with pytest.raises(RuntimeError, match="no count accumulator left"):
        acc(0, 0x40, 9, 1)
    topk_ops.release(keys[:1])  # the two-seed graph is gone
    assert acc(0, 0x40, 9, 1) == 4 and acc(0, 0x40, 10, 1) == 8
    with pytest.raises(RuntimeError, match="no count accumulator left"):
        acc(0, 0x40, 11, 1)
