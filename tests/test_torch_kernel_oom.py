"""Exp5's kernel-OOM arm, the benchmark configuration ``exp5-5k-oom``, on the
port's CPU route against the benchmark's plain reference (``portbench/``).

With Airlock off, above the kill watermark the survival scan names each
node's largest-memory resident and ``airlock.runtime_control`` destroys it:
the kill branch, its two scatter-adds and no suspension. The configuration
is cut to 64 nodes, zones of 32, 1024 slots and 64 arrivals a tick, as the
benchmark's own tests cut a cell; its memory block stays as published.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
for _p in (str(BENCH), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from benchlib import check, program, spec  # noqa: E402

SMALL = dict(num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64)
SEGMENT = 40  # ticks a simulate / simulate_batch call, chained as the benchmark chains them
TICKS = 120  # each seed's first 40 ticks already hold kills at this cut
SEED = 2_147_483_659  # past 32 signed bits, as the benchmark's seeds are


def _config(name: str) -> dict:
    return spec.load_json(BENCH / "configs" / f"{name}.json")


def test_the_configuration_is_exp5_with_airlock_off():
    oom, on = _config("exp5-5k-oom"), _config("exp5-5k")
    assert oom["config"]["airlock"] is False and on["config"]["airlock"] is True
    assert {**oom["config"], "airlock": True} == on["config"]
    assert oom["config"]["memory"]["enabled"] and oom["config"]["memory"]["kill_watermark"] == 1.0
    assert list(oom["reduced"]) == list(on["reduced"]) == ["horizon_ms"]
    assert oom["assumed"] == {}
    cell = spec.load_cell("exp5-oom-b4")
    assert cell.config == oom and cell.chips == 1 and cell.traffic_name == "stationary-b4"
    assert cell.traffic["seeds"] == 4 and cell.traffic["lockstep"]
    assert (cell.traffic["warmup_ticks"], cell.traffic["segment_ticks"]) == (800, 100)
    check.ref_config(cell)  # every field is a field of the reference's config


def _small_cell(seeds: int) -> spec.Cell:
    conf = copy.deepcopy(_config("exp5-5k-oom"))
    conf["config"].update(SMALL)
    traffic = "stationary-b4" if seeds > 1 else "stationary-b1"
    tr = copy.deepcopy(spec.load_json(BENCH / "traffic" / f"{traffic}.json"))
    tr.update(seeds=seeds, lockstep=seeds > 1, warmup_ticks=SEGMENT, segment_ticks=SEGMENT)
    return spec.Cell(name=f"small.exp5-5k-oom.{traffic}", config_name="exp5-5k-oom",
                     config=conf, traffic_name=traffic, traffic=tr, chips=1, end_to_end=[],
                     per_layer=[], root=BENCH)


@pytest.mark.parametrize("seeds", [2, 1], ids=["lockstep", "flat"])
def test_the_kernel_oom_arm_equals_the_reference(seeds):
    """``simulate_batch`` (two seeds in lockstep) or ``simulate`` (one seed),
    chained segment by segment from the initial state, against the
    reference's eager ticks of each seed: every element of the state, the
    series and ``summarize`` equal, kills in the run and no suspension."""
    cell = _small_cell(seeds)
    prog = program.Program(cell, SEED, "cpu")
    parts = [prog.segment()[2] for _ in range(TICKS // SEGMENT)]
    ts = torch.cat(parts, dim=1 if prog.lockstep else 0)
    ref = check.Reference(cell, prog.seeds, "cpu")
    for i in range(seeds):
        s0 = check.as_ref_state(prog.seed_state(prog.init_state, i))
        assert check.state_mismatches(s0, ref.init_state) == {}
        want, want_ts = ref.follow(ref.init_state, i, 0, TICKS)
        got, got_ts = prog.seed_state(prog.state, i), prog.seed_series(ts, i)
        assert check.state_mismatches(check.as_ref_state(got), want) == {}
        assert check.tensor_mismatches(got_ts, want_ts) == 0
        assert check.summary_mismatches(prog.summarize(got, got_ts),
                                        ref.summarize(want, want_ts)) == []
        m = got.metrics
        assert int(m.oom_kill_l) + int(m.oom_kill_f) > 0
        assert int(m.suspended_cnt) == 0 and int(m.reactivated) == 0
