"""The plain reference against the port's CPU route, the control against the
reference, and chained segments against one run (CPU, small configs)."""

import subprocess
import sys

import pytest
import torch
from conftest import HERE, small_cell

from benchlib import check, program, spec

CASES = [("exp5-5k", "stationary-b1"), ("exp5-5k", "storm-b3"), ("exp7-64k", "stationary-b1")]


def _port(cell):
    from repro_torch.core import config as pconfig

    return spec.build_config(pconfig, cell.config["config"], cell.traffic["scenario"])


def _port_run(cell, seed: int, ticks: int):
    """``ticks`` eager ticks of the port's tick on the CPU from its initial
    state, with its own draws: the final state, the series, the initial
    state."""
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.engine import LaminarEngine, make_step

    cfg = _port(cell)
    eng = LaminarEngine(cfg, device="cpu")
    s0, lam = eng.init(seed)
    s = s0
    d = TorchDraws(cfg, lam, s.zstart.shape[0], seed=seed, device="cpu")
    step = make_step(cfg)
    rows = []
    for t in range(ticks):
        s, row = step(s, d.tick(t))
        rows.append(row)
    return s, torch.stack(rows), s0


@pytest.mark.parametrize("config,traffic", CASES)
def test_the_reference_equals_the_ports_cpu_route(config, traffic):
    cell = small_cell(config, traffic, seeds=1)
    seed = 2_147_483_659
    s, ts, s0 = _port_run(cell, seed, 150)
    ref = check.Reference(cell, [seed], "cpu")
    assert check.state_mismatches(check.as_ref_state(s0), ref.init_state) == {}
    r, rts = ref.follow(ref.init_state, 0, 0, 150)
    assert check.state_mismatches(check.as_ref_state(s), r) == {}
    assert check.tensor_mismatches(ts, rts) == 0
    from repro_torch.core.engine import summarize

    assert check.summary_mismatches(summarize(_port(cell), s, ts.numpy()),
                                    ref.summarize(check.as_ref_state(s), ts)) == []
    assert int(s.metrics.started) > 0 and int(s.metrics.completed) > 0


@pytest.mark.parametrize("config,traffic", CASES[:2])
def test_a_lower_precision_fails_the_comparison(config, traffic):
    """The control: the reference with the state's float32 fields rounded
    through bfloat16 each tick differs from the reference."""
    cell = small_cell(config, traffic, seeds=1)
    ref = check.Reference(cell, [11], "cpu")
    r, _ = ref.follow(ref.init_state, 0, 0, 60)
    c, _ = ref.follow(ref.init_state, 0, 0, 60, round_to=torch.bfloat16)
    assert sum(check.state_mismatches(check.as_ref_state(c), r).values()) > 100


@pytest.mark.parametrize("traffic", ["stationary-b1", "storm-b3"])
def test_chained_segments_equal_one_run(traffic):
    """Segments of ``simulate`` chained as the window chains them equal one
    ``simulate`` of all their ticks, final state and series."""
    cell = small_cell("exp5-5k", traffic, seeds=1)
    chained = program.Program(cell, 21, "cpu")
    parts = [chained.segment()[2] for _ in range(5)]
    whole = program.Program(cell, 21, "cpu")
    whole.seg = 100
    _, end, ts, _ = whole.segment()
    assert check.state_mismatches(check.as_ref_state(chained.state),
                                  check.as_ref_state(end)) == {}
    assert torch.equal(torch.cat(parts), ts)


def test_storm_segments_need_their_burst_window():
    """Without the burst table set to each call's window, chained mmpp
    segments replay the first dwell segments' bursts: the run differs."""
    cell = small_cell("exp5-5k", "storm-b3", seeds=1)
    chained = program.Program(cell, 21, "cpu")
    chained.place = lambda: None
    for _ in range(5):
        chained.segment()
    whole = program.Program(cell, 21, "cpu")
    whole.seg = 100
    _, end, _, _ = whole.segment()
    assert check.state_mismatches(check.as_ref_state(chained.state), check.as_ref_state(end))


def test_a_periodic_schedule_needs_whole_periods():
    cell = small_cell("exp5-5k", "stationary-b1", seeds=1)
    cell.traffic["scenario"] = {"name": "diurnal", "schedule": {"kind": "diurnal"}}
    with pytest.raises(ValueError, match="periods"):
        program.Program(cell, 1, "cpu")


def test_the_reference_imports_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {str(HERE)!r}); "
            "import reference.tick, reference.draws, reference.hotpath; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_ordered_sum_adds_as_index_add_on_the_cpu(seed):
    """The survival scan's pressure sum, as the reference computes it on a
    card, equals the CPU's ``index_add_`` bit for bit."""
    from reference.survival_scan_ref import ordered_add

    g = torch.Generator().manual_seed(seed)
    N, P = 300, 20_000
    acc = torch.rand(N + 1, generator=g) * 0.7
    tgt = torch.randint(0, N + 1, (P,), generator=g)
    src = torch.rand(P, generator=g) * torch.rand(P, generator=g) * 3
    want = acc.clone().index_add_(0, tgt, src)
    assert torch.equal(ordered_add(acc, tgt, src)[:N], want[:N])
