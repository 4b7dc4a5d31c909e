"""Whole-engine parity of the port on the periodic arrival presets.

The port's flat engine, fed ``JaxTape`` (the JAX engine's draws, its
scheduled Poisson counts included), equals the live JAX engine on every
metric, ``lat_hist`` and the ``TS_FIELDS`` timeseries, for the ``diurnal``
and ``flash`` presets, Airlock off and on, on the 64-node config of
``tests/test_shard_engine.py`` (the other presets:
``test_torch_scenarios.py`` and ``test_torch_disruption.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from _torch_parity import check_run_matches_jax
from test_torch_scenarios import SMALL

from repro.workloads import SCENARIOS as J_SCENARIOS


@pytest.mark.parametrize("airlock", [False, True], ids=["oom", "airlock"])
@pytest.mark.parametrize("preset", ["diurnal", "flash"])
def test_preset_matches_jax(preset, airlock):
    cfg = dataclasses.replace(SMALL, scenario=J_SCENARIOS[preset], airlock=airlock)
    got = check_run_matches_jax(cfg)
    assert got["started"] > 500
    # the schedule moved the arrivals: some ticks see more than others
    per_tick = np.diff(got["timeseries"]["arrived"])
    assert per_tick.max() > 2 * max(per_tick.min(), 1)
