"""Whole runs of the port's baselines against live JAX runs fed the same tape.

For slurm, ray and flux on ``SMALL`` of ``tests/test_baselines.py`` under
the stationary and storm scenarios: ``JaxBaselineTape`` replays each
model's JAX key chain, the port runs on the CPU from those values, and
every ``BaseMetrics`` field, the summary, the per-tick ``(arrived,
started, completed)`` series and the final state (task table, ``free``
words, scenario state and every float carry) equal the JAX run's bit for
bit (``_torch_parity.check_baseline_run``): the ulp bound on the float
carries is 0.
"""

from __future__ import annotations

import dataclasses

import pytest
from _torch_parity import check_baseline_run

from repro.core import LaminarConfig
from repro.core.config import BaselineConfig
from repro.workloads.scenario import SCENARIOS

SMALL = LaminarConfig(
    num_nodes=128,
    zone_size=32,
    probe_capacity=2048,
    max_arrivals_per_tick=128,
    horizon_ms=250.0,
    rho=0.6,
)


@pytest.mark.parametrize("scenario", ["stationary", "storm"])
@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_run_equals_jax(name, scenario):
    cfg = dataclasses.replace(SMALL, scenario=SCENARIOS[scenario])
    out = check_baseline_run(name, cfg, BaselineConfig(), 1 << 13)
    assert out["started"] > 0
    if scenario == "storm":
        assert out["disrupt_killed"] > 0
    signature = {"ray": "spillbacks", "flux": "rollbacks"}.get(name)
    if signature:
        assert out[signature] > 0
