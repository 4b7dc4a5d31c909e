"""``BENCHMARK.json`` and the files it names: the contract's form, every
file found by name, new cells taken up from data alone, no CPU fallback,
no JAX."""

import json
import re
import shutil
import subprocess
import sys

import pytest
from conftest import HERE, benchmark_json

from benchlib import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_benchmark_json_has_the_contracts_form():
    b = benchmark_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for part, keys in KEYS.items():
        names = [e["name"] for e in b[part]]
        assert len(names) == len(set(names)), part
        for e in b[part]:
            assert set(e) - {"workloads"} == keys, (part, e["name"])
            assert NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert LINE.fullmatch(e[k]), (e["name"], k)
    for c in b["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] == 1
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    assert all(m["moves"] in e2e for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in benchmark_json()["workloads"]])
def test_every_cells_files_are_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["config"]["num_nodes"] > 0 and c.traffic["segment_ticks"] > 0
    assert c.traffic["warmup_ticks"] % c.traffic["segment_ticks"] == 0
    assert {m.name for m in c.end_to_end} >= {"setup_s", "sim_ticks_per_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m.name))
    from benchlib.check import ref_config

    ref_config(c)  # every field of the files is a field of the reference's config


def test_a_cell_added_as_files_is_taken_up_with_no_edit(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    b = benchmark_json()
    conf = json.loads((root / "configs" / "exp5-5k.json").read_text())
    conf["config"]["rho"] = 0.5
    (root / "configs" / "exp5-rho05.json").write_text(json.dumps(conf))
    tr = json.loads((root / "traffic" / "stationary-b4.json").read_text())
    tr["seeds"] = 2
    (root / "traffic" / "stationary-b2.json").write_text(json.dumps(tr))
    (root / "metrics" / "tick.replays.py").write_text("def read(trace):\n    return trace.replays\n")
    b["configs"].append({"name": "exp5-rho05", "source": "x", "file": "portbench/configs/exp5-rho05.json",
                         "reduced": ["rho"], "why": "x"})
    b["workloads"].append({"name": "exp5-rho05-b2", "config": "exp5-rho05",
                           "traffic": "stationary-b2", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "tick.replays", "unit": "count", "better": "lower",
                           "source": "device_trace", "layer": "x", "moves": "sim_ticks_per_s",
                           "workloads": ["exp5-rho05-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.load_cell("exp5-rho05-b2", root)
    assert c.config["config"]["rho"] == 0.5 and c.traffic["seeds"] == 2
    assert "tick.replays" in [m.name for m in c.per_layer]
    assert spec.reader("tick.replays", root)(type("T", (), {"replays": 7})()) == 7
    assert "tick.replays" not in [m.name for m in spec.load_cell("exp5-airlock-b4", root).per_layer]


@pytest.mark.parametrize("name", ["bad name", "a/b", "-x", "x" * 65, "muµ"])
def test_names_outside_the_alphabet_are_refused(name):
    with pytest.raises(ValueError):
        spec.check_name(name, "workload")


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "exp5-airlock-b1",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=HERE.parent)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA is not available" in p.stderr


def test_a_folder_without_the_port_fails(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "exp5-airlock-b1",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=tmp_path,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    """The harness, the reference and every metric reader, and a small cell
    run through them on the CPU, in a fresh process: no module whose
    top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (whole
    names: ``repro_torch`` is the port)."""
    code = f"""
import sys, time
sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent / 'src')!r}, {str(HERE / 'tests')!r}]
import run, control
from benchlib import spec, check, program, roofline, trace
import reference.tick, reference.draws
from conftest import small_cell
for m in [e["name"] for e in spec.load_json(spec.benchmark_file(spec.HERE))["per_layer"]]:
    spec.reader(m)
out = run.run_cell(small_cell("exp5-5k", "stationary-b1", warmup=100), 5, 0.0, False, "cpu",
                   time.perf_counter())
assert out["correct"], out
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "reference" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded & {"jax", "jaxlib", "flax", "repro"}
