"""A run with the timed path broken underneath comes out not correct, and so
does the control (the reference in bfloat16 in the program's place).

Each test drives the rest of a run (``run.run_cell``: warm-up, window,
check) on the CPU at a small size, past the harness's look for a card.
The faults a cell of this engine can have: a segment that returns its
state unchanged; half of a lockstep batch left out; an answer altered
where it is produced. There is no exchange between chips to leave out:
every cell runs the flat engine on one card.
"""

import time

import pytest
import torch
from conftest import small_cell

import control
import run
from benchlib import program


class Unchanged(program.Program):
    """Each segment hands back the state it was given."""

    def segment(self):
        self.place()
        start, t0 = self.state, self.tick
        _, ts = self._sim(self.state, self.draws, self.seg)
        self.tick += self.seg
        return start, start, ts, t0


class HalfBatch(program.Program):
    """Only the first half of the lockstep seeds advance; the others keep
    their state."""

    def segment(self):
        start, end, ts, t0 = super().segment()
        half = len(self.seeds) // 2

        def keep(new, old):
            out = new.clone()
            out[half:] = old[half:]
            return out

        end = type(end)(*(type(x)(*(keep(a, b) for a, b in zip(x, y))) if f == "metrics"
                          else keep(x, y) for f, x, y in zip(end._fields, end, start)))
        self.state = end
        return start, end, ts, t0


class Altered(program.Program):
    """The count of started tasks of the first seed is one too many."""

    def segment(self):
        start, end, ts, t0 = super().segment()
        m = end.metrics
        started = m.started.clone()
        started.view(-1)[0] += 1
        end = end._replace(metrics=m._replace(started=started))
        self.state = end
        return start, end, ts, t0


def _run(cell, prog_cls):
    return run.run_cell(cell, 1_000_003, 0.0, False, "cpu", time.perf_counter(), prog_cls)


def test_a_sound_run_is_correct():
    out = _run(small_cell("exp5-5k", "stationary-b4", seeds=2, warmup=100), program.Program)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault,traffic,seeds", [
    (Unchanged, "stationary-b1", 1),
    (Unchanged, "storm-b3", 2),
    (HalfBatch, "stationary-b4", 2),
    (HalfBatch, "storm-b3", 2),
    (Altered, "stationary-b1", 1),
    (Altered, "stationary-b4", 2),
])
def test_a_broken_timed_path_is_not_correct(fault, traffic, seeds):
    out = _run(small_cell("exp5-5k", traffic, seeds=seeds, warmup=100), fault)
    assert out["correct"] is False
    assert out["failed"] > 0
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("config,traffic", [("exp5-5k", "stationary-b1"),
                                            ("exp7-64k", "stationary-b1")])
def test_the_control_is_not_correct(config, traffic):
    cell = small_cell(config, traffic, seeds=1, warmup=100)
    out = control.control_run(cell, 77, "cpu")
    assert out["correct"] is False
    assert out["numbers"]["start"] > 0 and out["numbers"]["segment"] > 0


def test_the_control_stands_in_the_programs_place():
    """``run.run_cell`` with the control as its program: not correct."""
    cell = small_cell("exp5-5k", "stationary-b1", seeds=1, warmup=100)
    out = _run(cell, lambda c, s, d: control.ControlProgram(c, s, d, torch.bfloat16))
    assert out["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("traffic,seeds", [("stationary-b1", 1), ("stationary-b4", 2),
                                           ("storm-b3", 2)])
def test_a_small_cell_on_the_card_is_correct_and_traced(cuda_device, traffic, seeds):
    """The whole run on the card at a small size, traced: the compiled
    engine against the reference, and every per-layer reader reads."""
    import dataclasses

    from benchlib import spec
    from conftest import benchmark_json

    per_layer = [spec._metric(m, "per-layer") for m in benchmark_json()["per_layer"]]
    cell = dataclasses.replace(small_cell("exp5-5k", traffic, seeds=seeds, warmup=40),
                               per_layer=per_layer)
    out = run.run_cell(cell, 3_000_000_019, 0.5, True, cuda_device, time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m.name for m in per_layer}
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
