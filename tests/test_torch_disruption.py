"""Node disruption in the port, against the JAX package, on the CPU.

  * ``workloads.disruption.disruption_step`` equals the JAX transition on
    random node states (blocks that wrap at the array edge, recoveries),
    given the same event uniform and block start;
  * ``core.disrupt.apply`` equals the JAX stage on a bridged mid-run storm
    state, field for field: hard failure with Airlock (forced secondary
    re-addressing), without it (residents killed), and graceful drain, with
    failures and recoveries in the same tick;
  * whole-engine parity for the ``churn`` and ``storm`` presets, Airlock off
    and on (the port fed ``JaxTape``, 9-way key split included);
  * the identities of ``tests/test_conservation.py`` on the port's own runs
    (``TorchDraws``) under storm: task conservation, per tier too, the
    survival numerator, and no atoms held on a down node at any tick
    boundary.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from _torch_parity import check_run_matches_jax, jax_state_to_numpy, port_config
from test_conservation import CFG as CONS_CFG
from test_conservation import check_conservation
from test_torch_scenarios import SMALL

from repro.core import LaminarEngine
from repro.core import disrupt as jdisrupt
from repro.workloads import SCENARIOS as J_SCENARIOS
from repro.workloads import DisruptionConfig as JDisruption
from repro.workloads import ScenarioConfig as JScenario
from repro.workloads.disruption import disruption_step as j_step
from repro_torch.core import disrupt as tdisrupt
from repro_torch.core.engine import LaminarEngine as TorchEngine
from repro_torch.core.engine import make_step
from repro_torch.core.state import state_from_numpy, state_to_numpy
from repro_torch.workloads.disruption import disruption_step as t_step

DT = 0.5


def _site_draws(key, n):
    """The event uniform and block start the JAX process draws from ``key``."""
    k_evt, k_site = jax.random.split(key)
    u = jax.random.uniform(k_evt, ())
    start = jax.random.randint(k_site, (), 0, n)
    return types.SimpleNamespace(
        dis_u=torch.tensor(float(u)), dis_start=torch.tensor(int(start), dtype=torch.int32)
    )


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("p", [1.0, 0.5])
def test_disruption_step_matches_jax(n, p):
    d = JDisruption(enabled=True, fail_event_prob=p, fail_block=11, downtime_ms=7.0)
    td = port_config(dataclasses.replace(SMALL, scenario=JScenario(disruption=d))).scenario.disruption
    rng = np.random.default_rng(n)
    events = 0
    for seed in range(12):
        up = rng.uniform(size=n) < 0.7
        until = rng.integers(0, 40, n).astype(np.int32)
        t = np.int32(rng.integers(0, 40))
        key = jax.random.PRNGKey(seed)
        want = j_step(d, up, until, t, key, DT)
        dr = _site_draws(key, n)
        got = t_step(td, torch.from_numpy(up), torch.from_numpy(until), torch.tensor(t),
                     dr.dis_u, dr.dis_start, DT)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        events += bool(np.asarray(want[2]).any())
    assert events > 0


def test_disruption_block_wraps_at_the_edge():
    d = port_config(SMALL).scenario.disruption
    d = dataclasses.replace(d, enabled=True, fail_event_prob=1.0, fail_block=5)
    up = torch.ones(16, dtype=torch.bool)
    until = torch.zeros(16, dtype=torch.int32)
    up2, until2, fail, recover = t_step(d, up, until, torch.tensor(9, dtype=torch.int32),
                                        torch.tensor(0.0), torch.tensor(14, dtype=torch.int32), DT)
    assert fail.nonzero().flatten().tolist() == [0, 1, 2, 14, 15]
    assert not recover.any() and (up2 == ~fail).all()
    assert (until2[fail] == 9 + round(d.downtime_ms / DT)).all()


@pytest.fixture(scope="module")
def storm_mid_state():
    """A JAX storm run of the 64-node config, 150 ticks in: residents,
    reservations and down nodes are all present."""
    cfg = dataclasses.replace(SMALL, scenario=J_SCENARIOS["storm"])
    eng = LaminarEngine(cfg)
    s0, lam = eng.init(0)
    mid, _ = eng._runner(lam, 150)(s0)
    return mid


VARIANTS = {
    "hard-airlock": (True, False),
    "hard-oom": (False, False),
    "drain": (True, True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_matches_jax_on_bridged_state(storm_mid_state, variant):
    airlock, drain = VARIANTS[variant]
    scen = JScenario(
        name="forced",
        disruption=JDisruption(enabled=True, fail_event_prob=1.0, fail_block=8,
                               downtime_ms=80.0, drain=drain),
    )
    cfg = dataclasses.replace(SMALL, scenario=scen, airlock=airlock)
    tcfg = port_config(cfg)
    mid = storm_mid_state
    # also recover every node that is down: move the clock to their deadline
    down = ~np.asarray(mid.node_up)
    assert down.any()
    t_rec = int(np.asarray(mid.down_until)[down].max())
    hits = recoveries = 0
    for seed, t in ((0, int(mid.t)), (1, int(mid.t)), (2, t_rec), (3, t_rec)):
        s = mid._replace(t=jax.numpy.asarray(t, jax.numpy.int32))
        key = jax.random.PRNGKey(seed)
        want_s, want_mask = jdisrupt.apply(cfg, scen, s, key)
        ts = state_from_numpy(jax_state_to_numpy(s), "cpu")
        got_s, got_mask = tdisrupt.apply(tcfg, tcfg.scenario, ts, _site_draws(key, cfg.num_nodes))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        want = jax_state_to_numpy(want_s)
        got = state_to_numpy(got_s)
        for f, w in want.items():
            if f in ("key", "sched_key"):
                continue
            if f == "metrics":
                for k, v in w.items():
                    np.testing.assert_array_equal(got[f][k], v, err_msg=k)
            else:
                np.testing.assert_array_equal(got[f], w, err_msg=f)
        hits += int(want["metrics"]["evicted"] - jax_state_to_numpy(s)["metrics"]["evicted"])
        hits += int(np.asarray(want_mask).sum())
        recoveries += int(want["metrics"]["node_recoveries"]) - int(np.asarray(s.metrics.node_recoveries))
    assert recoveries > 0
    if not drain:
        assert hits > 0  # residents were displaced


@pytest.mark.parametrize("airlock", [False, True], ids=["oom", "airlock"])
@pytest.mark.parametrize("preset", ["churn", "storm"])
def test_preset_matches_jax(preset, airlock):
    cfg = dataclasses.replace(SMALL, scenario=J_SCENARIOS[preset], airlock=airlock)
    got = check_run_matches_jax(cfg)
    assert got["started"] > 500 and got["node_failures"] > 0 and got["evicted"] > 0
    assert (got["evicted_killed"] > 0) == (not airlock)


# ---------------------------------------------------------------------------
# conservation identities on the port's own runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("airlock", [False, True], ids=["oom", "airlock"])
def test_storm_conservation(airlock):
    cfg = port_config(dataclasses.replace(CONS_CFG, airlock=airlock,
                                          scenario=J_SCENARIOS["storm"]))
    out = TorchEngine(cfg, device="cpu").run(seed=0)
    assert out["started"] > 0 and out["node_failures"] > 0
    check_conservation(out, airlock=airlock)
    if not airlock:
        # disruption deaths count against execution survival
        killed = out["oom_kill_f"] + out["oom_kill_l"] + out["reclaimed"] + out["evicted_killed"]
        assert out["evicted_killed"] > 0
        assert out["exec_survival_ratio"] == pytest.approx(1.0 - killed / out["started"], abs=1e-12)


def test_down_nodes_hold_no_allocations_under_hard_failure():
    cfg = port_config(dataclasses.replace(CONS_CFG, scenario=J_SCENARIOS["storm"]))
    eng = TorchEngine(cfg, device="cpu")
    s, lam = eng.init(0)
    draws = eng.draws(lam, s.zstart.shape[0], 0)
    step = make_step(cfg)
    saw_down = 0
    for t in range(240):
        s, _ = step(s, draws.tick(t))
        up = s.node_up.numpy()
        if up.all():
            continue
        saw_down += 1
        held = np.zeros(cfg.num_nodes, np.int64)
        for node, alloc in ((s.alloc_node, s.alloc), (s.node2, s.alloc2)):
            nodes = node.numpy()
            live = nodes >= 0
            bits = np.unpackbits(alloc.numpy()[live].view(np.uint8), axis=-1).sum(axis=-1)
            np.add.at(held, nodes[live], bits.astype(np.int64))
        bad = np.flatnonzero(~up & (held > 0))
        assert bad.size == 0, f"tick {t}: down nodes {bad.tolist()} hold atoms"
        assert not s.free.numpy()[~up].any(), f"tick {t}: a down node advertises capacity"
    assert saw_down > 0
