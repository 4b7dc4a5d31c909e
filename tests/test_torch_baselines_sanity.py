"""``tests/test_baselines.py``'s sanity tests, on the port (CPU).

The same configurations, seeds and capacities as the JAX package's tests,
through ``repro_torch.core.baselines.RUNNERS`` with ``device="cpu"`` and
the port's own generator-backed draws: the accounting bounds and each
paradigm's signature regime must hold for them as they do for the
reference's draws.
"""

import dataclasses

import pytest
import torch

from repro_torch.core import LaminarConfig, LaminarEngine
from repro_torch.core.baselines import RUNNERS

# the parity helpers' setting: small tensors, one intra-op thread
torch.set_num_threads(1)

SMALL = LaminarConfig(
    num_nodes=128,
    zone_size=32,
    probe_capacity=2048,
    max_arrivals_per_tick=128,
    horizon_ms=250.0,
    rho=0.6,
)


@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_baseline_runs_and_accounts(name):
    out = RUNNERS[name](SMALL, seed=0, capacity=1 << 13, device="cpu")
    assert out["arrived"] > 0
    assert 0 <= out["start_success_raw"] <= 1.0
    assert out["started"] >= out["completed"] >= 0
    # conservation: every arrival is started, failed, timed out, in flight,
    # or dropped at capacity
    accounted = out["started"] + out["failed"] + out["timeout"] + out["in_flight_end"]
    assert accounted <= out["arrived"] + 1
    assert accounted >= 0.9 * out["arrived"] - out["dropped"] - 1


def test_slurm_saturates_at_scale():
    """The coordination-bound regime: at larger N (decision cost ~ N x scan),
    the global-mutex pipeline cannot keep up with lambda ~ N."""
    big = dataclasses.replace(
        SMALL, num_nodes=1024, zone_size=128, rho=0.8,
        probe_capacity=4096, horizon_ms=300.0,
    )
    out = RUNNERS["slurm"](big, seed=0, capacity=1 << 16, device="cpu")
    assert out["start_success_raw"] < 0.5  # saturated


def test_ray_spillback_under_high_load():
    hi = dataclasses.replace(SMALL, rho=0.9, horizon_ms=300.0)
    out = RUNNERS["ray"](hi, seed=0, capacity=1 << 14, device="cpu")
    assert out["spillbacks"] > 0


def test_laminar_beats_coordination_bound_baseline():
    """The globally-serialized (Slurm-like) paradigm loses to Laminar once
    decision cost ~ N x scan meets lambda ~ N; Ray and Flux show their
    signature stress mechanisms."""
    cfg = dataclasses.replace(
        SMALL, num_nodes=512, zone_size=64, rho=0.9,
        probe_capacity=8192, max_arrivals_per_tick=512, horizon_ms=300.0,
    )
    lam = LaminarEngine(cfg, device="cpu").run(seed=0)
    slurm = RUNNERS["slurm"](cfg, seed=0, capacity=1 << 15, device="cpu")
    assert lam["start_success_raw"] >= slurm["start_success_raw"] - 0.02
    ray = RUNNERS["ray"](cfg, seed=0, capacity=1 << 15, device="cpu")
    flux = RUNNERS["flux"](cfg, seed=0, capacity=1 << 15, device="cpu")
    assert ray["spillbacks"] > 0
    assert flux["rollbacks"] > 0
