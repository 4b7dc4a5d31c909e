"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` from the
root of the repository (CPU; the tests marked ``cuda`` skip without a card).
"""

import copy
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent  # portbench/
for _p in (str(HERE), str(HERE.parent / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from benchlib import spec  # noqa: E402

import torch  # noqa: E402

torch.set_num_threads(2)  # several test workers share the cores

SMALL = dict(num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64)


def small_cell(config: str, traffic: str, seeds=None, warmup: int = 40, segment: int = 20,
               **overrides) -> spec.Cell:
    """A committed configuration and traffic cut to 64 nodes and 1024 slots,
    segments of ``segment`` ticks (an mmpp dwell segment cut to one) and
    ``warmup`` ticks of warm-up; ``seeds`` overrides the traffic's."""
    conf = copy.deepcopy(spec.load_json(HERE / "configs" / f"{config}.json"))
    conf["config"].update(SMALL, **overrides)
    tr = copy.deepcopy(spec.load_json(HERE / "traffic" / f"{traffic}.json"))
    tr["warmup_ticks"] = warmup
    tr["segment_ticks"] = segment
    if tr["scenario"]["schedule"]["kind"] == "mmpp":
        tr["scenario"]["schedule"]["mmpp_dwell_ms"] = segment * conf["config"]["dt_ms"]
    if seeds is not None:
        tr["seeds"] = seeds
        tr["lockstep"] = seeds > 1
    return spec.Cell(name=f"small.{config}.{traffic}", config_name=config, config=conf,
                     traffic_name=traffic, traffic=tr, chips=1, end_to_end=[], per_layer=[],
                     root=HERE)


@pytest.fixture
def cuda_device():
    """The card, or a skip (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def benchmark_json() -> dict:
    with open(HERE.parent / "BENCHMARK.json") as f:
        return json.load(f)
