"""The whole engine of the port against the JAX engine, on the CPU.

The JAX engine runs ``SMALL`` and ``EXP5`` (memory dynamics on, Airlock off
and on) from seed 0 (the configs of ``tests/test_hotpath.py``). ``JaxTape``
replays its key schedule and feeds the recorded random values to the port's
engine (plain PyTorch versions on the CPU). Every ``summarize()`` metric,
``lat_hist`` and the ``TS_FIELDS`` timeseries must be equal, tick for tick.

The port's floats can differ from XLA's by an ulp where a transcendental
(log2, exp2, sin, exp) or a fused multiply-add enters, and a decision taken
on such a float could then flip at a near-tie. None does on these runs: the
test asserts exact equality over the whole horizon, and on a failure it
names the first tick and counter that diverged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from _torch_parity import JaxTape, assert_outputs_equal, first_divergence, port_config

from repro.core import LaminarConfig, LaminarEngine, MemoryConfig
from repro.core.engine import summarize as jax_summarize
from repro_torch.core.engine import LaminarEngine as TorchEngine

SMALL = LaminarConfig(
    num_nodes=64,
    zone_size=32,
    probe_capacity=1024,
    max_arrivals_per_tick=64,
    horizon_ms=150.0,
    rho=0.7,
)
EXP5 = dataclasses.replace(
    SMALL, rho=0.8, horizon_ms=200.0, memory=MemoryConfig(enabled=True)
)
CASES = {
    "small": SMALL,
    "exp5_oom": EXP5,
    "exp5_airlock": dataclasses.replace(EXP5, airlock=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(case):
    cfg = CASES[case]
    eng = LaminarEngine(cfg)
    s0, lam = eng.init(0)
    nt = cfg.num_ticks
    final, ts = eng._runner(lam, nt)(s0)
    want = jax_summarize(cfg, final, np.asarray(ts))
    want["lambda_per_s"] = lam / cfg.dt_ms * 1e3

    tape = JaxTape(cfg, lam, len(s0.zstart), seed=0, num_ticks=nt)
    got = TorchEngine(port_config(cfg), device="cpu").run(seed=0, draws=tape)

    assert first_divergence(want, got) is None, first_divergence(want, got)
    assert_outputs_equal(want, got)
    # the runs exercise what each config is about
    assert got["started"] > 1000
    if case == "exp5_oom":
        assert got["oom_kill_l"] + got["oom_kill_f"] > 0
    if case == "exp5_airlock":
        assert got["suspended_cnt"] > 0 and got["reactivated"] > 0
