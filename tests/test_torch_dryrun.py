"""The port's dry-run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline``) on the CPU, against the JAX package where
the two compute the same thing.

  * cells: on a fake (2, 4) mesh at smoke width, the qwen3-1.7b and
    olmoe-1b-7b train, prefill and decode cells report ``ok``, and a train
    cell counts ZeRO-3's all-gathers; a production-mesh cell opens its
    fake group of 256 (512) ranks and closes it;
  * the per-device FLOP count: one ``(8, 16) @ (16, 32)`` split over both
    axes of that mesh counts 1024, one device's share, not the global 8192;
  * memory: on a (1, 1) mesh ``argument_bytes`` is the bytes of the
    parameters, optimizer state and batch;
  * the record's keys are the reference's (its ``run_cell`` on a (1, 1)
    mesh, in a subprocess that may force its own host devices);
  * the 1-group / 2-group extrapolation of FLOPs equals the direct count
    of the full depth (four groups) exactly: the port's stack unrolls its
    groups. Bytes and collective bytes follow DTensor's redistribution
    choices, which change with the depth of the stacked leaves (a group
    axis of odd length is padded, a placement chosen for one depth is not
    for another), so they extrapolate within ``BYTES_RTOL``;
  * ``model_flops`` and ``suggestion`` equal the reference's for every
    arch x shape (pure arithmetic, exact);
  * ``main`` writes every cell under its results folder, records a failing
    cell as ``status: "error"`` and exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro.configs import list_archs
from repro_torch.configs import get as tget
from repro_torch.configs import get_smoke
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BYTES_RTOL = 0.10  # measured: up to 1.0 % (bytes) and 5.9 % (collective bytes)
SUGGESTION_CASES = [(d, u) for d in ("compute_s", "memory_s", "collective_s")
                    for u in (0.2, 0.5, 0.9)]


@pytest.fixture(scope="module")
def reference():
    """The reference's ``model_flops`` of every arch x shape, its
    ``suggestion`` on ``SUGGESTION_CASES`` and the keys of its dry-run
    record (``run_cell`` on a (1, 1) mesh), from a subprocess: importing
    ``repro.launch.dryrun`` or ``roofline`` forces JAX's host device count."""
    code = (
        "import os, json\n"
        "os.environ['REPRO_DRYRUN_DEVICES'] = '1'\n"
        "from repro.configs import get, list_archs\n"
        "from repro.configs.shapes import SHAPES\n"
        "from repro.launch import roofline\n"
        "from repro.launch.dryrun import run_cell\n"
        "from repro.launch.mesh import make_mesh\n"
        "rec = run_cell('qwen3-1.7b', 'decode_32k', False, verbose=False, smoke=True,\n"
        "               mesh=make_mesh((1, 1), ('data', 'model')))\n"
        f"cases = {SUGGESTION_CASES!r}\n"
        "print(json.dumps({\n"
        "  'keys': {k: sorted(v) if isinstance(v, dict) else None for k, v in rec.items()},\n"
        "  'model_flops': {f'{a}/{s}': roofline.model_flops(get(a), SHAPES[s])\n"
        "                  for a in list_archs() for s in SHAPES},\n"
        "  'suggestions': [roofline.suggestion({'dominant': d, 'useful_flops_ratio': u})\n"
        "                  for d, u in cases]}))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture
def mesh24():
    with fake_process_group(8):
        yield make_mesh((2, 4), ("data", "model"), "cpu")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_smoke_cells_are_ok_on_a_fake_mesh(mesh24, arch):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_cell(arch, shape, False, verbose=False, smoke=True, mesh=mesh24)
        assert rec["status"] == "ok" and rec["devices"] == 8, rec
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
        assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
        coll = rec["collectives"]
        assert coll["total_bytes"] == sum(v for k, v in coll.items()
                                          if k in dryrun.COLLECTIVE_KINDS)
        if shape == "train_4k":  # ZeRO-3: weights gathered over "data"
            assert coll["all-gather"] > 0 and coll["count"] > 0
    assert dryrun.run_cell(arch, "long_500k", False, smoke=True, mesh=mesh24)["status"] == "skip"


def test_flops_are_one_device_share(mesh24):
    with FakeTensorMode():
        a = sharding.shard_like(mesh24, torch.empty(8, 16, device="meta"), ("data", None))
        b = sharding.shard_like(mesh24, torch.empty(16, 32, device="meta"), (None, "model"))
        for _ in range(2):  # the first call also propagates shapes at global size
            cost = dryrun.LocalCost()
            with implicit_replication(), cost:
                out = a @ b
            assert cost.flops == 1024, cost.flops  # 2 * 4 * 16 * 8, not 2 * 8 * 16 * 32
            assert cost.collectives == {}
    assert tuple(out.to_local().shape) == (4, 8)


def test_argument_bytes_on_one_device_are_the_state_and_batch(tmp_path):
    cfg = get_smoke("qwen3-1.7b")
    shape = ShapeSpec("t", 32, 4, "train")
    params, ostate, batch = tsteps.abstract_inputs(cfg, shape)
    want = sum(x.numel() * x.element_size() for x in sharding.map_specs(
        lambda x, _: x, [params, ostate.mu, ostate.nu], [params, ostate.mu, ostate.nu])
        for x in _leaves(x))
    want += ostate.step.element_size() + sum(b.numel() * b.element_size() for b in batch.values())
    with fake_process_group(1):
        rec = dryrun.trace_cost(cfg, shape, tsteps.make_train_step(cfg),
                                make_mesh((1, 1), ("data", "model"), "cpu"))
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["generated_code_bytes"] is None
    assert rec["collectives"]["count"] >= 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [y for v in tree.values() for y in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [y for v in tree for y in _leaves(v)]
    return [tree]


def test_production_mesh_cells_close_their_group():
    for multi_pod, devices in ((False, 256), (True, 512)):
        rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", multi_pod, verbose=False, smoke=True)
        assert rec["status"] == "ok" and rec["devices"] == devices
        assert not dist.is_initialized()


def test_record_keys_are_the_reference_s(reference):
    want = reference["keys"]
    with fake_process_group(1):
        rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", False, verbose=False, smoke=True,
                              mesh=make_mesh((1, 1), ("data", "model"), "cpu"))
    got = {k: sorted(v) if isinstance(v, dict) else None for k, v in rec.items()}
    assert got.keys() == want.keys()
    assert got["memory"] == want["memory"] and got["cost"] == want["cost"]
    assert {"count", "total_bytes"} <= set(got["collectives"])


@pytest.mark.parametrize("arch,kind", [("qwen3-1.7b", "train"), ("olmoe-1b-7b", "prefill"),
                                       ("recurrentgemma-2b", "decode")])
def test_extrapolation_equals_the_direct_count(mesh24, arch, kind):
    smoke = get_smoke(arch)
    cfg = dataclasses.replace(smoke, n_layers=4 * len(smoke.pattern))  # four groups
    shape = ShapeSpec("t", 64, 8, kind)
    direct = roofline._measure(cfg, shape, mesh24)
    ex = roofline._extrapolate(cfg, shape, mesh24)
    assert ex["flops"] == direct["flops"] > 0
    for k in ("bytes", "coll"):
        assert abs(ex[k] - direct[k]) <= BYTES_RTOL * direct[k], (k, ex[k], direct[k])


def test_analyze_record(mesh24):
    cfg = get_smoke("qwen3-1.7b")
    rec = roofline.analyze(cfg, ShapeSpec("t", 64, 8, "train"), mesh24)
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["compute_s"] == rec["flops_per_device"] / roofline.PEAK_FLOPS
    assert rec["memory_s"] == rec["bytes_per_device"] / roofline.HBM_BW
    assert rec["collective_s"] == rec["coll_bytes_per_device"] / roofline.LINK_BW
    assert 0 < rec["roofline_fraction"]


def test_model_flops_equal_the_reference(reference):
    for arch in list_archs():
        for name in SHAPES:
            assert roofline.model_flops(tget(arch), SHAPES[name]) == \
                reference["model_flops"][f"{arch}/{name}"], (arch, name)


def test_suggestion_equals_the_reference(reference):
    for (dominant, useful), want in zip(SUGGESTION_CASES, reference["suggestions"]):
        assert roofline.suggestion({"dominant": dominant, "useful_flops_ratio": useful}) == want


def test_main_records_every_cell_and_fails_on_an_error(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)

    def fake_cell(arch, shape_name, multi_pod, **_):
        if shape_name == "prefill_32k":
            raise RuntimeError("no sharding strategy")
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "status": "ok"}

    monkeypatch.setattr(dryrun, "run_cell", fake_cell)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-1.7b", "--all"])
    assert e.value.code == 1
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 2 * len(SHAPES)
    bad = json.loads((tmp_path / "qwen3-1.7b__prefill_32k__multi.json").read_text())
    assert bad["status"] == "error" and "no sharding strategy" in bad["error"]
    assert "failures=2" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:  # cached cells are not run again
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k"])
    assert e.value.code == 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_moe_ep_constraint_pins_the_expert_buffers(mesh24, monkeypatch, kind):
    """``moe_ep_constraint`` on olmoe-1b-7b: the dispatch buffer and the
    expert output come out of ``expert_parallel`` as experts over "model"
    (``Shard(0)``) and replicated over "data", the reference's ``PS("model",
    None, None)``, and the cell's collective bytes move. Without the knob
    they keep DTensor's own placements (the buffer replicated, the output
    batch over "data" and partial over "model")."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import moe

    seen = []

    def recording(x, cfg):
        y = pinned(x, cfg)
        seen.append(tuple(y.placements))
        return y

    pinned = moe.expert_parallel
    monkeypatch.setattr(moe, "expert_parallel", recording)
    shape = ShapeSpec("t", 64, 8, kind)
    coll, where = {}, {}
    for knob in (False, True):
        cfg = dataclasses.replace(get_smoke("olmoe-1b-7b"), moe_ep_constraint=knob)
        step = tsteps.make_train_step(cfg) if kind == "train" else tsteps.make_prefill_step(cfg)
        seen.clear()
        coll[knob] = dryrun.trace_cost(cfg, shape, step, mesh24)["collectives"]["total_bytes"]
        where[knob] = list(seen)
    layers = get_smoke("olmoe-1b-7b").n_layers
    assert where[True] == [(Replicate(), Shard(0))] * (2 * layers), where[True]
    assert len(where[False]) == 2 * layers and where[False] != where[True], where[False]
    assert coll[True] != coll[False], coll
