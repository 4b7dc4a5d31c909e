"""The ``scenario`` argument of the port's ``run`` / ``run_batch`` against
the JAX package's, on the CPU.

The config's own scenario is stationary; each run asks for another one
through the argument. The port is fed the JAX engine's draws for that
scenario (``JaxTape``) and must equal the live JAX run on every metric,
``lat_hist`` and the ``TS_FIELDS`` series: flat ``run`` and ``run_batch``,
and the zone-sharded engine on two gloo ranks. Draws made for the config's
own scenario are refused under another.
"""

from __future__ import annotations

import dataclasses

import pytest
from _torch_parity import JaxTape, assert_outputs_equal, first_divergence, port_config
from test_torch_scenarios import SMALL

from repro.core import LaminarEngine as JaxEngine
from repro.workloads import SCENARIOS as J_SCENARIOS
from repro_torch.core.draws import ArrayDraws
from repro_torch.core.engine import LaminarEngine as TorchEngine
from repro_torch.parallel.local import run_local
from repro_torch.workloads.scenario import SCENARIOS as T_SCENARIOS

CFG = dataclasses.replace(SMALL, horizon_ms=60.0)  # its scenario: stationary
NAME = "storm"


def _tape(seed: int, lam: float, zones: int) -> JaxTape:
    """The JAX engine's draws for ``NAME`` from ``seed``."""
    return JaxTape(dataclasses.replace(CFG, scenario=J_SCENARIOS[NAME]), lam, zones,
                   seed=seed, num_ticks=CFG.num_ticks)


def _assert_equal(want: dict, got: dict) -> None:
    assert first_divergence(want, got) is None, first_divergence(want, got)
    assert_outputs_equal(want, got)


def test_config_runs_stationary():
    assert CFG.scenario.name == "stationary"
    assert port_config(CFG).scenario == T_SCENARIOS["stationary"]


def test_run_takes_the_scenario():
    want = JaxEngine(CFG).run(seed=0, scenario=J_SCENARIOS[NAME])
    eng = TorchEngine(port_config(CFG), device="cpu")
    s0, lam = eng.init(0)
    got = eng.run(seed=0, scenario=T_SCENARIOS[NAME], draws=_tape(0, lam, len(s0.zstart)))
    _assert_equal(want, got)
    assert want["node_failures"] > 0  # storm's disruption ran
    # and not the config's own scenario
    plain = JaxEngine(CFG).run(seed=0)
    assert plain["node_failures"] == 0


def test_run_batch_takes_the_scenario():
    seeds = [0, 3]
    want = JaxEngine(CFG).run_batch(seeds, scenario=J_SCENARIOS[NAME])
    eng = TorchEngine(port_config(CFG), device="cpu")
    s0, lam = eng.init(seeds[0])
    tapes = [_tape(sd, lam, len(s0.zstart)) for sd in seeds]
    got = eng.run_batch(seeds, scenario=T_SCENARIOS[NAME], draws=tapes)
    assert [o["seed"] for o in got] == seeds
    for a, b in zip(want, got):
        _assert_equal(a, b)
    assert want[0]["arrived"] != want[1]["arrived"]
    with pytest.raises(ValueError, match="draws for"):
        eng.run_batch(seeds, draws=tapes[:1])


def test_default_draws_follow_the_scenario():
    eng = TorchEngine(port_config(CFG), device="cpu")
    s0, lam = eng.init(0)
    assert eng.draws(lam, len(s0.zstart), 0).scenario.name == "stationary"
    assert eng.draws(lam, len(s0.zstart), 0, T_SCENARIOS[NAME]).scenario.name == NAME
    out = eng.run(seed=0, num_ticks=60, scenario=T_SCENARIOS[NAME])
    own = dataclasses.replace(port_config(CFG), scenario=T_SCENARIOS[NAME])
    assert_outputs_equal(TorchEngine(own, device="cpu").run(seed=0, num_ticks=60), out)
    # draws made for the config's scenario are refused under another
    with pytest.raises(ValueError, match="scenario"):
        eng.run(seed=0, num_ticks=4, scenario=T_SCENARIOS[NAME],
                draws=eng.draws(lam, len(s0.zstart), 0))


def test_sharded_engine_takes_the_scenario_on_two_ranks():
    want = JaxEngine(CFG).run(seed=0, scenario=J_SCENARIOS[NAME])
    s0, lam = TorchEngine(port_config(CFG), device="cpu").init(0)
    draws = ArrayDraws(_tape(0, lam, len(s0.zstart)).arrays)
    outs = run_local(port_config(CFG), 2, seed=0, draws=draws, device="cpu",
                     scenario=T_SCENARIOS[NAME])
    assert len(outs) == 2
    for got in outs:
        _assert_equal(want, got)
    assert want["node_failures"] > 0
