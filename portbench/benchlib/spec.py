"""The benchmark's description, read from ``BENCHMARK.json`` and the files it names.

Every cell is found by name: ``BENCHMARK.json``'s ``workloads`` entry gives
its configuration and traffic; the configuration's file is the one its
``configs`` entry names, the traffic's is ``traffic/<traffic>.json`` and a
per-layer metric's reader is ``metrics/<name>.py``, all beside this package.
A new cell, traffic mix or metric is a new file and a new entry: nothing
here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r} is not a name: a letter, digit or _, then at "
                         f"most 63 letters, digits, _, . and -")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ValueError(f"{what}'s unit {unit!r}: 1 to 16 letters, digits, _, /, %, . and -")
    return unit


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    bound: Optional[float] = None  # end-to-end metrics
    layer: Optional[str] = None  # per-layer metrics
    moves: Optional[str] = None
    workloads: Optional[tuple] = None  # the cells that report it (None: all)

    def reported_in(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell: its name, its configuration file's content, its traffic
    file's content, the chips it asks for, and the metrics it reports."""

    name: str
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path  # the benchmark's folder the files were read from


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _metric(entry: dict, kind: str) -> Metric:
    name = check_name(entry["name"], f"{kind} metric")
    if entry.get("better") not in ("lower", "higher"):
        raise ValueError(f"metric {name}: better must be 'lower' or 'higher'")
    wl = entry.get("workloads")
    return Metric(name=name, unit=check_unit(entry["unit"], name), better=entry["better"],
                  source=entry["source"], bound=entry.get("bound"), layer=entry.get("layer"),
                  moves=entry.get("moves"), workloads=None if wl is None else tuple(wl))


def benchmark_file(root: Path) -> Path:
    """``BENCHMARK.json`` at the root of the checkout that holds ``root``,
    the benchmark's folder."""
    return root.parent / "BENCHMARK.json"


def load_cell(name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration and traffic
    read from their files under ``root``."""
    bench = load_json(benchmark_file(root))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {sorted(cells)})")
    w = cells[check_name(name, "workload")]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[check_name(w["config"], "config")]
    traffic = check_name(w["traffic"], "traffic")
    return Cell(
        name=name,
        config_name=conf["name"],
        config=load_json(root.parent / conf["file"]),
        traffic_name=traffic,
        traffic=load_json(root / "traffic" / f"{traffic}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in (_metric(e, "end-to-end") for e in bench["end_to_end"])
                    if m.reported_in(name)],
        per_layer=[m for m in (_metric(e, "per-layer") for e in bench["per_layer"])
                   if m.reported_in(name)],
        root=root,
    )


def reader(metric: str, root: Path = HERE) -> Callable:
    """The ``read(trace)`` function of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{check_name(metric, 'metric')}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def build_config(mod, fields: Dict[str, Any], scenario: Dict[str, Any]):
    """A ``LaminarConfig`` of the config module ``mod`` (the program's or
    the reference's) from a configuration file's ``config`` and a traffic
    file's ``scenario``. Every field is given; a field the module does not
    know is refused."""
    f = dict(fields)
    nested = {"memory": mod.MemoryConfig, "workload": mod.WorkloadConfig}
    for key, cls in nested.items():
        if key in f:
            f[key] = cls(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in f[key].items()})
    sc = scenario_module(mod)
    f["scenario"] = sc.ScenarioConfig(
        name=scenario["name"],
        schedule=sc.ScheduleConfig(**scenario.get("schedule", {})),
        disruption=sc.DisruptionConfig(**scenario.get("disruption", {})),
    )
    return mod.LaminarConfig(**f)


def scenario_module(config_mod):
    """The scenario module beside a config module (its ``ScenarioConfig``)."""
    return importlib.import_module(config_mod.ScenarioConfig.__module__)
