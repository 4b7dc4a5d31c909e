"""Stage by stage, the port's tick against the JAX package's, on the CPU.

A JAX engine runs Exp5-sized (64 nodes, memory dynamics on, Airlock off and
on) for 150 ticks; then one more tick runs stage by stage
(``_torch_parity.jax_staged_tick``). Each stage of the port gets the JAX
state that stage read, carried over with ``state_from_numpy``, and the same
random values, and must give the JAX stage's output: integers and masks
exactly, floats within rtol 1e-6 (XLA's own sin / exp / log2 may differ from
PyTorch's by an ulp; on the reference machine they agree exactly).

Also here: ``TorchDraws`` samples the same distributions as the JAX engine's
draws (moment checks), and ``run_batch`` keeps the JAX package's semantics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import jax_staged_tick, jax_state_to_numpy, port_config

from repro.core import LaminarConfig, LaminarEngine, MemoryConfig
from repro_torch.core import airlock, arbiter, da, engine, hotpath, teg, zhaf
from repro_torch.core.draws import TorchDraws, max_dispatch
from repro_torch.core.engine import LaminarEngine as TorchEngine
from repro_torch.core.state import state_from_numpy, state_to_numpy

EXP5 = LaminarConfig(
    num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
    horizon_ms=200.0, rho=0.8, memory=MemoryConfig(enabled=True),
)
MID_RUN_TICKS = 150


@pytest.fixture(scope="module", params=[False, True], ids=["oom", "airlock"])
def staged(request):
    cfg = dataclasses.replace(EXP5, airlock=request.param)
    eng = LaminarEngine(cfg)
    s0, lam = eng.init(0)
    mid, _ = eng._runner(lam, MID_RUN_TICKS)(s0)
    draws, rec = jax_staged_tick(cfg, mid, lam)
    return port_config(cfg), draws, {name: (s, out, extra) for name, s, out, extra in rec}


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(tc, name, ts, d, ex):
    if name == "memory_dynamics":
        return airlock.memory_dynamics(tc, ts, d)
    if name == "survival_scan":
        return hotpath.survival_scan(tc, ts)
    if name == "runtime_control":
        return airlock.runtime_control(tc, ts, ex["victim"])
    if name == "airlock_transitions":
        return airlock.airlock_transitions(tc, ts, ex["resume"], ex["react"], ex["expire"])
    if name == "completions":
        return arbiter.completions(tc, ts)
    if name == "build_view":
        return zhaf.build_view(tc, ts)
    if name == "report":
        return zhaf.report(tc, ts, d, ex["view"])
    if name == "refresh":
        return teg.refresh(tc, ts)
    if name == "inject_arrivals":
        return engine._inject_arrivals(tc, ts, d)
    if name == "move":
        return da.move(tc, ts, d)
    if name == "dispatch":
        return teg.dispatch(tc, ts, d, ex["mask"], max_dispatch(tc))
    if name == "address":
        return da.address(tc, ts, d, ex["view"])
    if name.startswith("arbitrate"):
        return arbiter.arbitrate(tc, ts, ex["throttled"], ex["bits"])
    if name == "pending_stage":
        return arbiter.pending_stage(tc, ts)
    if name == "timeouts":
        return arbiter.timeouts(tc, ts)
    raise KeyError(name)


def _flatten(x, prefix=""):
    """(path, numpy array) pairs of a state, view, tuple or tensor."""
    if isinstance(x, dict):
        for k, v in x.items():
            if k not in ("key", "sched_key"):
                yield from _flatten(v, f"{prefix}.{k}")
    elif isinstance(x, tuple) and hasattr(x, "metrics"):  # a SimState
        yield from _flatten(state_to_numpy(x) if isinstance(x.st, torch.Tensor)
                            else jax_state_to_numpy(x), prefix)
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


STAGES = [
    "memory_dynamics", "survival_scan", "runtime_control", "airlock_transitions",
    "completions", "build_view", "report", "refresh", "inject_arrivals", "move",
    "dispatch", "address", "arbitrate0", "arbitrate1", "arbitrate2",
    "pending_stage", "timeouts",
]


@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_jax(staged, name):
    tc, d, rec = staged
    s_in, want, extra = rec[name]
    ts = state_from_numpy(jax_state_to_numpy(s_in), "cpu")
    ex = {
        k: (zhaf.NodeView(*(_t(v) for v in val)) if k == "view" else _t(val))
        for k, val in extra.items()
    }
    out = _port(tc, name, ts, d, ex)
    if name == "build_view":  # the port's view holds no bit plane: no stage reads it
        assert out.bits is None
        out, want = out[1:], want[1:]
    got = dict(_flatten(out))
    want = dict(_flatten(want))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if w.dtype == np.uint32:  # bitmap words: int32 bit patterns in the port
            g = g.view(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def test_mid_run_state_is_busy(staged):
    """The bridged states exercise the stages: residents, queued probes and
    arrivals are all present mid-run."""
    _, _, rec = staged
    st = np.asarray(rec["address"][0].st)
    assert (st == 6).sum() > 50 and (st == 2).sum() > 0
    assert int(np.asarray(rec["dispatch"][2]["mask"]).sum()) > 0


def test_address_entry_equals_the_composition_it_replaced(staged):
    """On the bridged state the addressing stage reads, the one-entry plain
    version (``utility_topk_address_ref``, through ``hotpath``) equals the
    composition it replaced (``_torch_parity.address_composition``) on every
    output, exactly."""
    from _torch_parity import address_composition

    from repro_torch import profile_tick

    tc, d, rec = staged
    s_in, _, extra = rec["address"]
    ts = state_from_numpy(jax_state_to_numpy(s_in), "cpu")
    view = zhaf.NodeView(*(_t(v) for v in extra["view"]))
    with profile_tick.recording("utility_topk_address") as calls:
        hotpath.utility_topk_address(tc, ts, d, view)
    ((args, kw, got),) = calls["utility_topk_address"]
    want = address_composition(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[-1][0]) > 0  # addressing probes in the bridged state


# ---------------------------------------------------------------------------
# TorchDraws samples the JAX engine's distributions
# ---------------------------------------------------------------------------


def test_torch_draws_moments():
    cfg = port_config(EXP5)
    lam, Z, ticks = 18.3, 2, 200
    prov = TorchDraws(cfg, lam, Z, seed=7, device="cpu")
    draws = [prov.tick(t) for t in range(ticks)]
    # (the disruption values are absent: this scenario has no disruption)
    col = {
        f: torch.stack([getattr(d, f) for d in draws]).double()
        for f in draws[0]._fields
        if getattr(draws[0], f) is not None
    }
    assert set(draws[0]._fields) - set(col) == {"dis_u", "dis_start"}

    def near(x, mean, sd):
        se = sd / np.sqrt(x.numel())
        assert abs(float(x.mean()) - mean) < 6 * se, (float(x.mean()), mean)
        assert abs(float(x.std()) - sd) < 0.05 * sd, (float(x.std()), sd)

    for f in ("burst_u", "burst_v", "rep_loss", "arr_l", "arr_squat", "oc_u", "oc_v",
              "move_loss", "launch_u", "cand_u"):
        near(col[f], 0.5, np.sqrt(1 / 12))
        assert float(col[f].min()) >= 0.0 and float(col[f].max()) < 1.0
    for f in ("mem_noise", "rep_jit", "arr_svc_norm", "addr_eps"):
        near(col[f], 0.0, 1.0)
    for f in ("arr_svc_exp", "arr_pull_exp"):
        near(col[f], 1.0, 1.0)
    near(col["gumbel"], 0.5772156649, np.pi / np.sqrt(6))
    near(col["arr_n"], lam, np.sqrt(lam))
    w = cfg.workload
    for f, values, probs in (
        ("arr_tier", range(len(w.tier_probs)), w.tier_probs),
        ("arr_mass_f", w.f_masses, w.f_mass_probs),
        ("arr_mass_l", w.l_masses, w.l_mass_probs),
        ("arr_pri_f", w.f_priorities, w.f_priority_probs),
        ("arr_pri_l", w.l_priorities, w.l_priority_probs),
    ):
        x = col[f]
        for v, p in zip(values, probs):
            freq = float((x == v).double().mean())
            assert abs(freq - p) < 6 * np.sqrt(p * (1 - p) / x.numel()), (f, v, freq, p)
        assert float(sum((x == v).double().mean() for v in values)) == pytest.approx(1.0)
    assert draws[0].arr_tier.dtype == torch.int32 and draws[0].arr_n.dtype == torch.int32


def test_torch_draws_seeded_and_copied():
    """One seed gives one stream; a CPU generator's values reach the device
    the provider names (here the CPU itself)."""
    cfg = port_config(EXP5)
    a = TorchDraws(cfg, 5.0, 2, seed=3, device="cpu").tick(0)
    b = TorchDraws(cfg, 5.0, 2, seed=3, device="cpu", generator_device="cpu").tick(0)
    c = TorchDraws(cfg, 5.0, 2, seed=4, device="cpu").tick(0)
    for f in a._fields:
        if getattr(a, f) is None:  # no disruption values without disruption
            assert getattr(b, f) is None
            continue
        torch.testing.assert_close(a.__getattribute__(f), b.__getattribute__(f), rtol=0, atol=0)
    assert not torch.equal(a.addr_eps, c.addr_eps)


def test_run_batch_shares_geometry_and_matches_single_run():
    cfg = port_config(dataclasses.replace(EXP5, airlock=True))
    eng = TorchEngine(cfg, device="cpu")
    outs = eng.run_batch([0, 1], num_ticks=60)
    single = eng.run(seed=0, num_ticks=60)
    for f, v in single["timeseries"].items():
        np.testing.assert_array_equal(outs[0]["timeseries"][f], v, err_msg=f)
    assert outs[0]["arrived"] == single["arrived"] > 0
    assert outs[1]["arrived"] != outs[0]["arrived"]
    assert [o["seed"] for o in outs] == [0, 1]
