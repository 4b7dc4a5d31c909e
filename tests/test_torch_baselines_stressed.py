"""The port's baselines against live JAX runs where their penalties bite.

The 512-node, rho 0.9 configuration of ``tests/test_baselines.py``'s
``test_laminar_beats_coordination_bound_baseline``, with the thresholds of
the three penalties lowered so that each engages within the 300 ms
horizon: Slurm's lock convoy (``slurm_convoy_depth`` 2000: the queue passes
it after about 20 ticks), Ray's USL collapse (``ray_usl_depth`` 20) and
Flux's root choke (``flux_root_choke`` 50, scale 400). Each run equals the
JAX run fed the same tape exactly (``_torch_parity.check_baseline_run``:
float carries bit-equal), and the test asserts that the penalty engaged.
"""

from __future__ import annotations

import pytest
from _torch_parity import check_baseline_run

from repro.core import LaminarConfig
from repro.core.config import BaselineConfig

STRESSED = LaminarConfig(
    num_nodes=512, zone_size=64, rho=0.9, probe_capacity=8192,
    max_arrivals_per_tick=512, horizon_ms=300.0,
)
BCFG = BaselineConfig(slurm_convoy_depth=2000, ray_usl_depth=20, flux_root_choke=50,
                      flux_root_choke_scale=400.0)
# the count each penalty reads, taken at the end of each tick: nothing joins
# it after the step reads it, so a count above the threshold at the end of a
# tick means the penalty acted in that tick
ENGAGED = {
    "slurm": (lambda s: s.tt.st == 1, BCFG.slurm_convoy_depth),
    "ray": (lambda s: (s.tt.st == 1) & (s.tt.shard != -1), BCFG.ray_usl_depth),
    "flux": (lambda s: (s.tt.st != 0) & (s.tt.st != 3), BCFG.flux_root_choke),
}


@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_stressed_run_equals_jax_with_penalty_engaged(name):
    mask, threshold = ENGAGED[name]
    peak = []
    out = check_baseline_run(name, STRESSED, BCFG, 1 << 15,
                             observe=lambda s: peak.append(int(mask(s).sum())))
    assert max(peak) > threshold, (max(peak), threshold)
    assert out["started"] > 0
