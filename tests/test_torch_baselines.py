"""The port's baseline models against the JAX package, function by function.

  * ``common.top_k`` against ``jax.lax.top_k`` on keys full of ties: the
    same indices in the same order;
  * ``floatops`` (XLA's float32 ``exp`` / ``log`` / ``log1p``) and the
    baselines' latency bucket against jitted JAX; its host constants
    (``f32``, ``recip``) against numpy's float32;
  * ``inject``, ``admit_fifo`` (score ties included), ``complete``,
    ``expire``, ``scenario_disrupt`` and ``summarize_baseline`` on JAX
    mid-run states carried into the port (``common.state_from_numpy``);
  * the draws provider, the bridge and the device default.

Whole runs are held to live JAX runs in ``test_torch_baselines_parity.py``
and ``test_torch_baselines_stressed.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    _arrival_draws,
    _disruption_draws,
    assert_summaries_equal,
    jax_baseline_run,
    port_baseline_config,
    port_config,
    state_differences,
)

from repro.core import LaminarConfig
from repro.core.baselines import common as JC
from repro.core.config import BaselineConfig
from repro.core.state import latency_bucket as jax_latency_bucket
from repro.workloads.scenario import SCENARIOS
from repro_torch.core.baselines import RUNNERS, flux_like, ray_like, slurm_like
from repro_torch.core.baselines import common as TC
from repro_torch.core import floatops
from repro_torch.core.baselines.draws import (
    ArrayBaselineDraws,
    BaselineDraws,
    TorchBaselineDraws,
    num_leaves,
)

SMALL = LaminarConfig(
    num_nodes=128,
    zone_size=32,
    probe_capacity=2048,
    max_arrivals_per_tick=128,
    horizon_ms=250.0,
    rho=0.6,
)
STORM = dataclasses.replace(SMALL, scenario=SCENARIOS["storm"])
CAP = 1 << 13
MID_TICKS = 200  # the mid-run states: storm, 200 ticks into each model's run


@functools.lru_cache(maxsize=None)
def mid_state(name: str):
    """The JAX model's state ``MID_TICKS`` ticks into a storm run (numpy)."""
    _, fin, _, _ = jax_baseline_run(name, STORM, BaselineConfig(), 0, CAP, MID_TICKS)
    return fin


def jax_tuple(cls, d):
    """A JAX NamedTuple of class ``cls`` from nested numpy dicts."""
    nested = {"tt": JC.TaskTable, "scen": JC.ScenarioState, "metrics": JC.BaseMetrics}
    return cls(**{f: jax_tuple(nested[f], d[f]) if f in nested else jnp.asarray(d[f])
                  for f in cls._fields})


def both(name: str):
    """The mid-run ``(tt, metrics, free)`` of ``name`` as JAX values and as
    the port's CPU tensors."""
    d = mid_state(name)
    j = (jax_tuple(JC.TaskTable, d["tt"]), jax_tuple(JC.BaseMetrics, d["metrics"]),
         jnp.asarray(d["free"]))
    t = (TC.state_from_numpy(TC.TaskTable, d["tt"], "cpu"),
         TC.state_from_numpy(TC.BaseMetrics, d["metrics"], "cpu"),
         torch.from_numpy(np.ascontiguousarray(d["free"]).view(np.int32).copy()))
    return j, t, d


def assert_same(want, got, what):
    """A JAX value and the port's equal bit for bit (words as uint32)."""
    if hasattr(want, "_fields"):
        diff = state_differences(
            {f: np.asarray(getattr(want, f)) for f in want._fields}, TC.state_to_numpy(got)
        )
        assert not diff, (what, diff)
    else:
        w, g = np.asarray(want), got.numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(w, g, err_msg=what)


# ---------------------------------------------------------------------------
# top_k: lax.top_k's order on ties
# ---------------------------------------------------------------------------


def _keys(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "small_ints":
        return rng.integers(0, 5, 1 << 17).astype(np.int32)
    if kind == "all_equal":
        return np.zeros(4096, np.int32)
    if kind == "ages":  # -arrival of queued tasks, NO_AGE elsewhere
        age = -rng.integers(0, 40, 1 << 15).astype(np.int32)
        return np.where(rng.random(1 << 15) < 0.3, age, TC.NO_AGE).astype(np.int32)
    if kind == "slack":  # free atoms per node, few distinct values
        return rng.integers(40, 48, 5000).astype(np.int32)
    raise ValueError(kind)


@pytest.mark.parametrize("k", [16, 64, 256, 384])
@pytest.mark.parametrize("kind", ["small_ints", "all_equal", "ages", "slack"])
def test_top_k_matches_lax_top_k_on_ties(kind, k):
    x = _keys(kind)
    _, want = jax.lax.top_k(jnp.asarray(x), k)
    got = TC.top_k(torch.from_numpy(x), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# floatops: XLA's float32 rounding
# ---------------------------------------------------------------------------


def _exp_args():
    rng = np.random.default_rng(1)
    k = np.arange(1 << 17, dtype=np.float32)
    return np.concatenate([
        rng.uniform(-90, 90, 400_000).astype(np.float32),
        -(k * np.float32(floatops.recip(2000.0))),  # the default choke's arguments
        -(k * np.float32(floatops.recip(400.0))),
    ])


def _log_args():
    rng = np.random.default_rng(2)
    return np.concatenate([
        np.arange(1, 1 << 18, dtype=np.float32),
        rng.uniform(0, 1e6, 300_000).astype(np.float32),
        np.exp(rng.uniform(-80, 80, 300_000)).astype(np.float32),
    ])


@pytest.mark.parametrize("fn", ["exp", "log", "log1p"])
def test_floatops_equal_jitted_jax(fn):
    if fn == "exp":
        x = _exp_args()
    elif fn == "log":
        x = _log_args()
    else:  # the leaf slack: whole numbers (and the domain above sqrt(2) - 1)
        x = np.concatenate([np.arange(0, 1 << 16, dtype=np.float32),
                            np.random.default_rng(3).uniform(0.4143, 1e5, 300_000)
                            .astype(np.float32)])
    want = np.asarray(jax.jit(getattr(jnp, fn))(x))
    got = getattr(floatops, fn)(torch.from_numpy(x)).numpy()
    bad = np.nonzero(want.view(np.int32) != got.view(np.int32))[0]
    assert len(bad) == 0, (fn, x[bad[:5]], want[bad[:5]], got[bad[:5]])


def test_latency_bucket_equals_jitted_jax_at_every_latency():
    """Every latency of 0 .. 2**18 ticks, through the reference's jitted
    ``latency_bucket`` and the port's."""
    t = np.int32(1 << 18)
    arrival = np.arange(1 << 18, dtype=np.int32)
    want = np.asarray(jax.jit(
        lambda a: jax_latency_bucket((t - a).astype(jnp.float32) * SMALL.dt_ms))(arrival))
    got = TC.latency_bucket(torch.from_numpy(t - arrival).to(torch.float32) * SMALL.dt_ms)
    np.testing.assert_array_equal(want, got.numpy())


def test_fma_rounds_once():
    a = torch.tensor([1.0 + 2.0**-23], dtype=torch.float32)
    c = torch.tensor([-(1.0 + 2.0**-22)], dtype=torch.float32)
    # a * a = 1 + 2**-22 + 2**-46: one rounding keeps the 2**-46, two lose it
    assert floatops.fma(a, a, c).item() == 2.0**-46
    assert (a * a + c).item() == 0.0


@pytest.mark.parametrize("fn", ["f32", "recip"])
def test_host_constants_equal_numpy_float32(fn):
    """``f32`` / ``recip`` equal numpy's float32 cast and quotient, the edges
    too: zeros, subnormals, overflow to infinity, infinities and NaN."""
    rng = np.random.default_rng(0)
    xs = [0.0, -0.0, 1e-50, -1e-50, 1e-45, 3.4028235e38, 3.40282356e38, 1e39, -1e39,
          math.inf, -math.inf, math.nan,
          *(rng.standard_normal(2000) * 10.0 ** rng.integers(-40, 40, 2000))]
    want = {"f32": lambda x: np.float32(x), "recip": lambda x: np.float32(1) / np.float32(x)}[fn]
    with np.errstate(all="ignore"):
        for x in xs:
            np.testing.assert_array_equal(np.float64(getattr(floatops, fn)(x)), np.float64(want(x)))
            assert math.copysign(1, getattr(floatops, fn)(x)) == math.copysign(1, want(x)) or x != x


# ---------------------------------------------------------------------------
# the shared substrate on bridged mid-run states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_inject_matches_jax(name):
    (jtt, jm, _), (ttt, tm, _), d = both(name)
    t = int(d["t"])
    key = jax.random.PRNGKey(1234 + t)
    lam = 90.0
    want = jax.jit(lambda tt, m: JC.inject(STORM, tt, m, key, lam, jnp.int32(t)))(jtt, jm)
    draws = BaselineDraws(**{k: torch.from_numpy(np.array(v))
                             for k, v in _arrival_draws(STORM, lam, key).items()})
    got = TC.inject(port_config(STORM), ttt, tm, draws, torch.tensor(t, dtype=torch.int32))
    for w, g, what in zip(want, got, ("tt", "metrics", "mask")):
        assert_same(w, g, what)
    assert int(got[1].arrived) > int(tm.arrived)


def _cands(kind: str, st: np.ndarray, t: int):
    """A candidate mask, node per task and the tick for ``admit_fifo``."""
    P = st.shape[0]
    waiting = (st != TC.B_EMPTY) & (st != TC.B_RUNNING)
    slot = np.arange(P)
    if kind == "waiting":
        return waiting, None, t
    # E_v-free FIFO ties: one arrival tick, four nodes, late enough that
    # -arrival * 1e3 swallows the slot term in whole runs of slots
    cand = waiting | (slot % 3 == 0)
    return cand, (slot % 4).astype(np.int32), (t if kind == "ties" else 10_000)


@pytest.mark.parametrize("kind", ["waiting", "ties", "late_ties"])
@pytest.mark.parametrize("name", ["ray", "flux"])
def test_admit_fifo_matches_jax(name, kind):
    (jtt, jm, jfree), (ttt, tm, tfree), d = both(name)
    cand, node, t = _cands(kind, d["tt"]["st"], int(d["t"]))
    if node is not None:
        arrival = np.full_like(d["tt"]["arrival"], t - 1)
        jtt = jtt._replace(node=jnp.asarray(node), arrival=jnp.asarray(arrival))
        ttt = ttt._replace(node=torch.from_numpy(node), arrival=torch.from_numpy(arrival))
    want = jax.jit(lambda tt, free, m, c: JC.admit_fifo(STORM, tt, free, c, jnp.int32(t), m))(
        jtt, jfree, jm, jnp.asarray(cand))
    got = TC.admit_fifo(port_config(STORM), ttt, tfree, torch.from_numpy(cand),
                        torch.tensor(t, dtype=torch.int32), tm)
    for w, g, what in zip(want, got, ("tt", "free", "metrics", "admit", "reject")):
        assert_same(w, g, what)
    assert bool(got[3].any())
    if node is not None:
        # every candidate whose score rounds equal to its node's best wins,
        # all with the node's one allocation (the reference's rule): more
        # than one a node once -arrival * 1e3 swallows the slot term
        winners = int((got[3] | got[4]).sum())
        assert winners > 4 if kind == "late_ties" else winners >= 4


@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_complete_matches_jax(name):
    (jtt, jm, jfree), (ttt, tm, tfree), _ = both(name)
    want = jax.jit(lambda tt, free, m: JC.complete(STORM, tt, free, m))(jtt, jfree, jm)
    got = TC.complete(port_config(STORM), ttt, tfree, tm)
    for w, g, what in zip(want, got, ("tt", "free", "metrics")):
        assert_same(w, g, what)


@pytest.mark.parametrize("use_timeout", [True, False])
@pytest.mark.parametrize("name", ["ray", "flux"])
def test_expire_matches_jax(name, use_timeout):
    (jtt, jm, _), (ttt, tm, _), d = both(name)
    bcfg = BaselineConfig(task_timeout_ms=20.0)  # some waiting tasks are late
    t = int(d["t"])
    want = jax.jit(lambda tt, m: JC.expire(STORM, bcfg, tt, m, jnp.int32(t), use_timeout))(
        jtt, jm)
    got = TC.expire(port_config(STORM), port_baseline_config(bcfg), ttt, tm,
                    torch.tensor(t, dtype=torch.int32), use_timeout)
    for w, g, what in zip(want, got, ("tt", "metrics")):
        assert_same(w, g, what)
    if use_timeout:
        assert int(got[1].timeout) > int(tm.timeout)


def _event_key(cfg, seed):
    """A key whose disruption draw fires an event."""
    for i in range(10_000):
        key = jax.random.PRNGKey(seed + i)
        dd = _disruption_draws(cfg, key)
        if float(dd["dis_u"]) < cfg.scenario.disruption.fail_event_prob:
            return key, dd
    raise AssertionError("no event key")


@pytest.mark.parametrize("drain", [False, True])
@pytest.mark.parametrize("name", ["slurm", "flux"])
def test_scenario_disrupt_matches_jax(name, drain):
    cfg = dataclasses.replace(STORM, scenario=dataclasses.replace(
        STORM.scenario, disruption=dataclasses.replace(STORM.scenario.disruption, drain=drain)))
    (jtt, jm, jfree), (ttt, tm, tfree), d = both(name)
    t = int(d["t"])
    key, dd = _event_key(cfg, 17 + t)
    jscen = jax_tuple(JC.ScenarioState, d["scen"])
    want = jax.jit(lambda sc, tt, free, m: JC.scenario_disrupt(
        cfg, sc, tt, free, m, jnp.int32(t), key))(jscen, jtt, jfree, jm)
    tscen = TC.state_from_numpy(TC.ScenarioState, d["scen"], "cpu")
    got = TC.scenario_disrupt(port_config(cfg), tscen, ttt, tfree, tm,
                              torch.tensor(t, dtype=torch.int32),
                              torch.from_numpy(np.array(dd["dis_u"])),
                              torch.from_numpy(np.array(dd["dis_start"])))
    for w, g, what in zip(want, got, ("scen", "tt", "free", "metrics")):
        assert_same(w, g, what)
    killed = int(got[3].disrupt_killed) - int(tm.disrupt_killed)
    assert (killed == 0) if drain else (killed > 0)


@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_summarize_baseline_matches_jax(name):
    (jtt, jm, _), (ttt, tm, _), _ = both(name)
    assert_summaries_equal(JC.summarize_baseline(STORM, jm, jtt),
                           TC.summarize_baseline(port_config(STORM), tm, ttt))


@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_state_bridge_round_trip(name):
    d = mid_state(name)
    cls = {"slurm": slurm_like.SlurmState, "ray": ray_like.RayState,
           "flux": flux_like.FluxState}[name]
    s = TC.state_from_numpy(cls, d, "cpu")
    assert s.free.dtype == torch.int32 and s.tt.alloc.dtype == torch.int32
    assert not state_differences(d, TC.state_to_numpy(s))


# ---------------------------------------------------------------------------
# draws, entry points, device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_torch_draws_shapes(name):
    cfg = port_config(STORM)
    d = TorchBaselineDraws(name, cfg, 40.0, CAP, seed=3, device="cpu").tick(5)
    n_max, N = cfg.max_arrivals_per_tick, cfg.num_nodes
    assert d.arr_l.shape == (n_max,) and d.arr_n.dtype == torch.int32
    assert d.dis_u.shape == () and 0 <= int(d.dis_start) < N
    own = {"ray": ("local_node", "shard_u", "pick_node"), "flux": ("leaf_gumbel", "leaf_off")}
    for f in ("local_node", "shard_u", "pick_node", "leaf_gumbel", "leaf_off"):
        assert (getattr(d, f) is not None) == (f in own.get(name, ()))
    if name == "ray":
        assert d.pick_node.shape == (CAP, 4) and d.local_node.dtype == torch.int32
        assert int(d.pick_node.min()) >= 0 and int(d.pick_node.max()) < N
    if name == "flux":
        assert d.leaf_gumbel.shape == (CAP, num_leaves(cfg))
        assert int(d.leaf_off.max()) < 32


def test_runs_refuse_draws_made_for_another_run():
    cfg = port_config(SMALL)
    storm = port_config(STORM)
    bad = {
        "model": TorchBaselineDraws("ray", cfg, 40.0, CAP, seed=0, device="cpu"),
        "scenario": TorchBaselineDraws("slurm", storm, 40.0, CAP, seed=0, device="cpu"),
        "capacity": TorchBaselineDraws("slurm", cfg, 40.0, CAP // 2, seed=0, device="cpu"),
    }
    for what, draws in bad.items():
        with pytest.raises(ValueError, match=what):
            slurm_like.run(cfg, capacity=CAP, num_ticks=2, device="cpu", draws=draws)
    arrays = ArrayBaselineDraws({}, "flux", cfg.scenario, CAP)
    with pytest.raises(ValueError, match="model"):
        slurm_like.run(cfg, capacity=CAP, num_ticks=2, device="cpu", draws=arrays)


def test_disruption_needs_its_draws():
    storm = port_config(STORM)
    plain = TorchBaselineDraws("slurm", port_config(SMALL), 40.0, CAP, seed=0, device="cpu")
    ticks = [plain.tick(t) for t in range(2)]
    arrays = {f: np.stack([getattr(d, f).numpy() for d in ticks])
              for f in BaselineDraws._fields if getattr(ticks[0], f) is not None}
    # claims the storm scenario, carries no disruption values
    draws = ArrayBaselineDraws(arrays, "slurm", storm.scenario, CAP)
    with pytest.raises(ValueError, match="disruption"):
        slurm_like.run(storm, capacity=CAP, num_ticks=2, device="cpu", draws=draws)


@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_runs_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        RUNNERS[name](port_config(SMALL), capacity=CAP, num_ticks=1)
    out = RUNNERS[name](port_config(SMALL), capacity=CAP, num_ticks=3, device="cpu")
    assert out["arrived"] > 0


def test_same_seed_same_run():
    cfg = port_config(SMALL)
    a = ray_like.run(cfg, seed=4, capacity=CAP, num_ticks=40, device="cpu")
    assert_summaries_equal(a, ray_like.run(cfg, seed=4, capacity=CAP, num_ticks=40, device="cpu"))
    assert a["arrived"] != ray_like.run(cfg, seed=5, capacity=CAP, num_ticks=40, device="cpu")["arrived"]
