"""The port's examples and dev smokes (``examples/torch_*.py``,
``scripts/torch_smoke_*.py``) on the CPU, against the reference's scripts.

  * configs and text: each reference script (``examples/quickstart.py``,
    ``examples/cluster_survival.py``, ``scripts/smoke_engine.py``,
    ``scripts/smoke_baselines.py``) runs through ``runpy.run_path`` with its
    engine (``repro.core.LaminarEngine``, or the entries of
    ``repro.core.baselines.RUNNERS``) replaced by a stub that records the
    config and returns a fixed summary, a short run of the port's own. The
    recorded configs, carried across by ``_torch_parity.port_config``, equal
    the port script's, and the reference's printed text for that summary
    equals the port script's ``report`` of it. Nothing of the JAX package
    is edited;
  * the engine examples' runs: at each one's own geometry (quickstart, and
    cluster_survival with Airlock off and on), the port's engine fed the
    JAX draws equals the live JAX engine (``check_run_matches_jax``). The
    horizon is cut to ``PARITY_TICKS`` ticks (of 2000 and 2400): the JAX
    engine's compile and the CPU's plain versions would take minutes at
    the full horizon; the card runs the full one (``chip_smoke.py`` phase
    13);
  * serve: the port example's stats line equals the reference example's
    (``test_torch_serving.py::test_serve_stats_do_not_depend_on_the_model``
    shows the stats do not depend on the weights);
  * train: the example prints the reference's lines, its losses those of
    ``launch.train.run`` under a 1x1 mesh at the same settings;
  * models: the smoke of qwen3-1.7b and whisper-base (its frame
    embeddings) gives finite losses and the right shapes; the other archs
    run on the card (``chip_smoke.py`` phase 13);
  * no fallback: each ``main([])`` raises without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import check_run_matches_jax, port_config

import repro.core
import repro.core.baselines
from repro_torch.configs import get_smoke
from repro_torch.core import LaminarConfig, LaminarEngine, MemoryConfig
from repro_torch.core.baselines import RUNNERS as TORCH_RUNNERS
from repro_torch.launch import train as ttrain

ROOT = Path(__file__).resolve().parent.parent
PARITY_TICKS = 100
SERVE_TICKS = 8  # one decode batch shape: one compile of the reference's decode
TINY = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
                     horizon_ms=10.0, rho=0.8, memory=MemoryConfig(enabled=True))
REFERENCE = {
    "quickstart": "examples/quickstart.py",
    "cluster_survival": "examples/cluster_survival.py",
    "smoke_engine": "scripts/smoke_engine.py",
    "smoke_baselines": "scripts/smoke_baselines.py",
}
PORT = {
    "quickstart": "examples/torch_quickstart.py",
    "cluster_survival": "examples/torch_cluster_survival.py",
    "serve_laminar": "examples/torch_serve_laminar.py",
    "train_lm": "examples/torch_train_lm.py",
    "smoke_engine": "scripts/torch_smoke_engine.py",
    "smoke_baselines": "scripts/torch_smoke_baselines.py",
    "smoke_models": "scripts/torch_smoke_models.py",
}


def load(name: str):
    """The port's script ``name`` as a module (it runs nothing on import)."""
    spec = importlib.util.spec_from_file_location(f"torch_{name}", ROOT / PORT[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def summaries():
    """A short run of the port's engine and of its Slurm-like baseline: the
    fixed summaries the stubs return."""
    return (LaminarEngine(TINY, device="cpu").run(seed=0),
            TORCH_RUNNERS["slurm"](TINY, capacity=1 << 10, device="cpu"))


@pytest.fixture(scope="module")
def reference(summaries):
    """Each reference script run with its engine stubbed: ``{name: (calls,
    text)}``, ``calls`` the (config, seed[, capacity]) of every run."""
    out, bout = summaries
    got = {}
    for name, path in REFERENCE.items():
        calls = []

        class Engine:
            def __init__(self, cfg):
                self.cfg = cfg

            def run(self, seed=0):
                calls.append((self.cfg, seed))
                return dict(out)

        def runner(tag):
            def run(cfg, seed=0, capacity=None):
                calls.append((tag, cfg, seed, capacity))
                return dict(bout)
            return run

        text = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(text):
            mp.setattr(repro.core, "LaminarEngine", Engine)
            for tag in list(repro.core.baselines.RUNNERS):
                mp.setitem(repro.core.baselines.RUNNERS, tag, runner(tag))
            runpy.run_path(str(ROOT / path), run_name="__main__")
        got[name] = (calls, text.getvalue())
    return got


def test_quickstart_config_and_text_are_the_reference_s(reference, summaries):
    calls, text = reference["quickstart"]
    port = load("quickstart")
    assert [(port_config(c), s) for c, s in calls] == [(port.CFG, 0)]
    assert text == port.report(port.CFG, summaries[0]) + "\n"


def test_cluster_survival_configs_and_text_are_the_reference_s(reference, summaries):
    calls, text = reference["cluster_survival"]
    port = load("cluster_survival")
    cfgs = [dataclasses.replace(port.BASE, airlock=a) for a in (False, True)]
    assert [(port_config(c), s) for c, s in calls] == [(c, 0) for c in cfgs]
    assert text == "".join(port.report(c, summaries[0]) + "\n" for c in cfgs)


def test_smoke_engine_config_and_text_are_the_reference_s(reference, summaries):
    """Two runs on one engine, seeds 0 and 1; the stub's runs take no
    time, so both scripts print 0.0 s."""
    calls, text = reference["smoke_engine"]
    port = load("smoke_engine")
    assert [(port_config(c), s) for c, s in calls] == [(port.CFG, 0), (port.CFG, 1)]
    assert text == port.report(summaries[0], 0.0, 0.0) + "\n"


def test_smoke_baselines_config_and_text_are_the_reference_s(reference, summaries):
    calls, text = reference["smoke_baselines"]
    port = load("smoke_baselines")
    assert [(t, port_config(c), s, cap) for t, c, s, cap in calls] == [
        (t, port.CFG, 0, port.CAPACITY) for t in TORCH_RUNNERS]
    assert text == "".join(port.report(t, summaries[1], 0.0) + "\n" for t in TORCH_RUNNERS)


@pytest.mark.parametrize("name,run", [("quickstart", 0), ("cluster_survival", 0),
                                      ("cluster_survival", 1)],
                         ids=["quickstart", "cluster_survival-airlock-off",
                              "cluster_survival-airlock-on"])
def test_engine_example_matches_jax(reference, name, run):
    cfg = reference[name][0][run][0]
    check_run_matches_jax(dataclasses.replace(cfg, horizon_ms=PARITY_TICKS * cfg.dt_ms))


def _stats_line(argv, run):
    text = io.StringIO()
    saved = sys.argv
    try:
        with contextlib.redirect_stdout(text):
            run(argv)
    finally:
        sys.argv = saved
    return text.getvalue().splitlines()[0]


def test_serve_example_stats_are_the_reference_s():
    def reference(argv):
        sys.argv = ["serve_laminar.py", *argv]
        runpy.run_path(str(ROOT / "examples/serve_laminar.py"), run_name="__main__")

    ticks = ["--ticks", str(SERVE_TICKS)]
    want = _stats_line(ticks, reference)
    got = _stats_line(["--device", "cpu", *ticks], load("serve_laminar").main)
    assert got == want and "completed=1 " in got


def test_train_example_prints_the_reference_s_lines(tmp_path, capsys):
    steps = 2
    out = load("train_lm").main(["--device", "cpu", "--steps", str(steps), "--batch", "2",
                                 "--seq", "16", "--ckpt-dir", str(tmp_path / "example")])
    lines = capsys.readouterr().out.splitlines()
    cfg = get_smoke("qwen3-1.7b")
    want = ["", f"arch={cfg.name} ({cfg.family})",
            *(f"  step {s:>4}: loss {loss:.4f}" for s, loss in zip(range(steps), out["losses"])),
            f"final loss after {steps} steps: {out['final_loss']:.4f}"]
    assert lines[-len(want):] == want
    assert [m["step"] for m in out["log"]] == list(range(steps))  # log_every = max(2 // 20, 1)
    assert (tmp_path / "example" / "step_00000001" / "COMMITTED").exists()  # ckpt_every = 1
    drv = ttrain.run(cfg, steps=steps, batch=2, seq=16, lr=3e-3, warmup_steps=10,
                     ckpt_dir=str(tmp_path / "driver"), ckpt_every=1, mesh="1x1", device="cpu")
    np.testing.assert_array_equal(out["losses"], drv["losses"])


def test_models_smoke_is_finite(capsys):
    archs = ["qwen3-1.7b", "whisper-base"]
    got = load("smoke_models").main(["--device", "cpu", *(a for n in archs for a in ("--arch", n))])
    assert list(got) == archs
    for r in got.values():
        assert r["shapes_ok"] and r["finite"] and np.isfinite(r["loss"]), r
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == archs
    assert all("shapes_ok=True finite=True" in ln for ln in lines), lines


@pytest.mark.parametrize("name", sorted(PORT))
def test_main_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load(name).main([])
