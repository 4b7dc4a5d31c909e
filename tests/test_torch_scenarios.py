"""Scenario arrival schedules in the port, against the JAX package, on the CPU.

  * ``workloads.schedule``: ``rate_factor`` / ``rate_per_tick`` of every
    kind equal the JAX functions over a range of ticks, given the JAX
    package's burst state of each mmpp segment (``diurnal``: its phase
    bit-equal to the jitted reference's, the factor and rate within
    ``DIURNAL_ULP``, what ``torch.sin`` against XLA's ``sin`` leaves); the
    claimed periods agree.
  * ``TorchDraws`` under a schedule: one burst draw per mmpp segment (every
    tick of a segment gets the same rate), seeded, and the Poisson count is
    drawn at the scheduled rate; under disruption it carries the event
    uniform and block start, and TEG's wider dispatch rows.
  * Whole-engine parity on the 64-node config of ``tests/test_shard_engine.py``
    for the ``stationary`` and ``bursty`` presets, Airlock off and on: the
    port's flat engine fed ``JaxTape`` equals the live JAX engine on every
    metric, ``lat_hist`` and the ``TS_FIELDS`` timeseries. (``diurnal`` and
    ``flash`` are in ``test_torch_scenarios_periodic.py``, ``churn`` and
    ``storm`` in ``test_torch_disruption.py``.)

The comparison is with live JAX runs on this tree, not with the pinned
``GOLDEN`` literals of ``tests/test_scenarios.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import check_run_matches_jax, port_config

from repro.core import LaminarConfig, MemoryConfig
from repro.workloads import SCENARIOS as J_SCENARIOS
from repro.workloads import schedule as jsched
from repro_torch.core.draws import TorchDraws, max_dispatch
from repro_torch.workloads import SCENARIOS as T_SCENARIOS
from repro_torch.workloads import schedule as tsched

DT = 0.5
PRESETS = ("stationary", "bursty")
SMALL = LaminarConfig(
    num_nodes=64,
    zone_size=32,
    probe_capacity=1024,
    max_arrivals_per_tick=64,
    horizon_ms=100.0,
    rho=0.7,
    memory=MemoryConfig(enabled=True),
    airlock=True,
)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


# torch.sin against XLA's sin: the largest distance of the diurnal factor
# (and rate) from the jitted JAX values, measured over three periods and
# the grid of test_rate_matches_jax
DIURNAL_ULP = 5


def _ulp(got, want) -> int:
    """Largest distance in float32 units in the last place (same signs)."""
    g = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    w = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(g - w).max())


def _jax_bursts(sched, ts, seed):
    """The JAX package's burst state of each tick's mmpp segment."""
    key = jsched.schedule_key(seed)
    dwell = jsched._ticks(sched.mmpp_dwell_ms, DT)
    f = jax.vmap(
        lambda t: jax.random.bernoulli(
            jax.random.fold_in(key, (t // dwell).astype(jnp.int32)), sched.mmpp_burst_prob
        )
    )
    return np.asarray(f(jnp.asarray(ts, jnp.int32)))


@pytest.mark.parametrize("preset", ["stationary", "bursty", "diurnal", "flash"])
@pytest.mark.parametrize("seed", [0, 3])
def test_rate_matches_jax(preset, seed):
    jsc = J_SCENARIOS[preset].schedule
    tsc = T_SCENARIOS[preset].schedule
    ts = np.arange(0, 5000, 7, dtype=np.int32)
    key = jsched.schedule_key(seed)
    bursts = _jax_bursts(jsc, ts, seed)
    t, b = torch.from_numpy(ts), torch.from_numpy(bursts.copy())
    for lam in (12.0, 0.37):
        want_f = jax.jit(jax.vmap(lambda t: jsched.rate_factor(jsc, t, key, DT)))(ts)
        want = jax.jit(jax.vmap(lambda t: jsched.rate_per_tick(jsc, lam, t, key, DT)))(ts)
        got_f = tsched.rate_factor(tsc, t, b, DT)
        lam_t, cap_t = (torch.tensor(x, dtype=torch.float32) for x in (lam, tsched.rate_cap(tsc, lam)))
        got = tsched.rate_per_tick(tsc, lam_t, cap_t, t, b, DT)
        assert got.dtype == torch.float32
        if preset == "diurnal":
            # the phase is bit-equal to the jitted JAX phase; XLA's sin
            # differs from torch.sin, which leaves the factor and the rate
            # up to DIURNAL_ULP from the jitted JAX values (torch.sin of
            # JAX's own phase is as far). The engine parity is untouched:
            # the tape carries the JAX package's Poisson counts.
            assert _ulp(got_f.numpy(), want_f) <= DIURNAL_ULP
            assert _ulp(got.numpy(), want) <= DIURNAL_ULP
        else:
            np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tsched.schedule_period_ticks(tsc, DT) == jsched.schedule_period_ticks(jsc, DT)
    if preset == "bursty":
        assert 0 < bursts.sum() < len(bursts)  # both states occur


def test_diurnal_phase_is_bit_equal_to_jitted_jax():
    """Over three periods the port's phase equals the phase the jitted
    reference computes (its expression, ``repro/workloads/schedule.py:90``,
    under ``jax.jit``), and the factor stays within DIURNAL_ULP."""
    jsc, tsc = J_SCENARIOS["diurnal"].schedule, T_SCENARIOS["diurnal"].schedule
    period = jsched._ticks(jsc.diurnal_period_ms, DT)
    ts = np.arange(0, 3 * period, dtype=np.int32)
    want = jax.jit(lambda t: 2.0 * jnp.pi * (t % period).astype(jnp.float32) / period)(ts)
    got = tsched.diurnal_phase(tsc, torch.from_numpy(ts), DT)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = jsched.schedule_key(0)
    want_f = jax.jit(jax.vmap(lambda t: jsched.rate_factor(jsc, t, key, DT)))(ts)
    got_f = tsched.rate_factor(tsc, torch.from_numpy(ts), None, DT)
    assert _ulp(got_f.numpy(), want_f) <= DIURNAL_ULP


def test_burst_states_are_a_seeded_prefix():
    sc = T_SCENARIOS["bursty"].schedule
    a = tsched.burst_states(sc, 5, 40)
    np.testing.assert_array_equal(tsched.burst_states(sc, 5, 400)[:40], a)
    assert not np.array_equal(tsched.burst_states(sc, 6, 40), a)
    assert 0.15 < tsched.burst_states(sc, 5, 4000).mean() < 0.45  # p = 0.3


def test_torch_draws_one_rate_per_mmpp_segment():
    cfg = port_config(dataclasses.replace(SMALL, scenario=J_SCENARIOS["bursty"]))
    sc = cfg.scenario.schedule
    dwell = tsched._ticks(sc.mmpp_dwell_ms, cfg.dt_ms)
    lam = 9.0
    prov = TorchDraws(cfg, lam, 2, seed=1, device="cpu")
    rates = np.array([float(prov._rate(t)) for t in range(30 * dwell)]).reshape(30, dwell)
    assert (rates == rates[:, :1]).all()  # constant inside every segment
    lo, hi = np.float32(lam * sc.mmpp_lo_factor), np.float32(lam * sc.mmpp_hi_factor)
    assert set(np.unique(rates).astype(np.float32)) == {lo, hi}
    want = np.where(tsched.burst_states(sc, 1, 30), hi, lo)
    np.testing.assert_array_equal(rates[:, 0].astype(np.float32), want)
    # asking out of order gives the same states (one draw per segment)
    again = TorchDraws(cfg, lam, 2, seed=1, device="cpu")
    assert float(again._rate(29 * dwell)) == rates[29, 0]
    # the arrival count follows the scheduled rate
    n = np.array([int(prov.tick(t).arr_n) for t in range(30 * dwell)]).reshape(30, dwell)
    burst = rates[:, 0] == hi
    assert n[burst].mean() > 3 * n[~burst].mean()


def test_torch_draws_under_disruption():
    cfg = port_config(dataclasses.replace(SMALL, scenario=J_SCENARIOS["storm"]))
    prov = TorchDraws(cfg, 5.0, 3, seed=2, device="cpu")
    d = [prov.tick(t) for t in range(400)]
    u = torch.stack([x.dis_u for x in d])
    start = torch.stack([x.dis_start for x in d])
    assert u.dtype == torch.float32 and start.dtype == torch.int32
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.1
    assert int(start.min()) >= 0 and int(start.max()) < cfg.num_nodes
    D = max_dispatch(cfg)
    assert D == cfg.max_arrivals_per_tick + 256 + 2 * 8 * cfg.atoms_per_node
    assert d[0].gumbel.shape == (D, 3) and d[0].launch_u.shape == (D,)
    # without disruption the provider draws no disruption values and keeps
    # the narrower dispatch rows
    plain = port_config(SMALL)
    a = TorchDraws(plain, 5.0, 3, seed=2, device="cpu").tick(0)
    assert a.dis_u is None and a.gumbel.shape == (max_dispatch(plain), 3)


# ---------------------------------------------------------------------------
# whole-engine parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("airlock", [False, True], ids=["oom", "airlock"])
@pytest.mark.parametrize("preset", PRESETS)
def test_preset_matches_jax(preset, airlock):
    cfg = dataclasses.replace(SMALL, scenario=J_SCENARIOS[preset], airlock=airlock)
    got = check_run_matches_jax(cfg)
    assert got["started"] > 500
