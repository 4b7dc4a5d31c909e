"""The port's laminar-check (``repro_torch.analysis``), on the CPU.

Nets, as ``tests/test_analysis.py`` holds the JAX analyzer:

  * the known-bad fixtures of ``tests/fixtures/torch_analysis/`` make every
    rule of the port's catalog fire;
  * the port's tree is clean on all three planes, and the tick set of the
    lint is not vacuous;
  * the CLI (``python -m repro_torch.analysis``, with JAX blocked from
    import) exits 0 on the tree and 1 on each fixture, with the JSON schema;
  * suppression directives, the README's rule table, the launch plans;
  * against the JAX package: the three grid fixtures give the same rule set
    per target as ``tests/fixtures/analysis/bad_blockspec_tail.py`` does
    under the JAX analyzer, and the plan interpreter equals the JAX
    ``pallas_call`` in interpret mode on the same seeded input, exactly
    (NaN where both are NaN).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro_torch.analysis import kernel_contract, lint, trace_audit
from repro_torch.analysis.findings import RULES, Finding, filter_suppressed
from repro_torch.kernels.block_copy import block_copy, block_copy_ref
from repro_torch.kernels.block_copy import plan as copy_plan
from repro_torch.kernels.launch_plan import Carve, Launch, LaunchPlan, Operand, Output
from repro_torch.workloads.scenario import SCENARIOS

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
TESTS = ROOT / "tests"
FIXTURES = TESTS / "fixtures" / "torch_analysis"
JAX_FIXTURE = TESTS / "fixtures" / "analysis" / "bad_blockspec_tail.py"

STATIC_FIXTURES = {
    "bad_traced_if.py": {"LC101"},
    "bad_np_in_tick.py": {"LC102"},
    "bad_kernel_pkg/ops.py": {"LC103"},
    "bad_config_mutation.py": {"LC104"},
}
DYNAMIC_FIXTURES = {
    "bad_traced_if.py": {"LC101"},
    "bad_dtype.py": {"LC202", "LC203"},
    "bad_mode_parity.py": {"LC204", "LC304"},
    "bad_signature_cachekey.py": {"LC201"},
    "bad_launch_tail.py": {"LC301", "LC302", "LC303"},
    "bad_cluster.py": {"LC303"},
}
ALL_FIXTURES = sorted(set(STATIC_FIXTURES) | set(DYNAMIC_FIXTURES))


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _targets(path: Path):
    return _module(path, f"_torch_fixture_{path.stem}").LAMINAR_CHECK_TARGETS


def _run_targets(path: Path):
    return [f for target in _targets(path) for f in target()]


# ---------------------------------------------------------------------------
# fixture corpus: every rule fires
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(STATIC_FIXTURES))
def test_static_fixture_fires(name):
    fired = {f.rule for f in lint.lint_paths([FIXTURES / name])}
    assert STATIC_FIXTURES[name] <= fired, (name, fired)


@pytest.mark.parametrize("name", sorted(DYNAMIC_FIXTURES))
def test_dynamic_fixture_fires(name):
    fired = {f.rule for f in _run_targets(FIXTURES / name)}
    assert DYNAMIC_FIXTURES[name] <= fired, (name, fired)


def test_every_rule_has_a_fixture():
    covered = set().union(*STATIC_FIXTURES.values(), *DYNAMIC_FIXTURES.values())
    assert covered == set(RULES), set(RULES) ^ covered


def test_lint_flags_each_kind_of_host_sync(tmp_path):
    p = tmp_path / "tick.py"
    p.write_text(
        "import torch\n"
        "def make_step(cfg):\n"
        "    def step(x: torch.Tensor, d):\n"
        "        a = int(x.sum())\n"                 # 4
        "        b = x.tolist()\n"                    # 5
        "        c = x.cpu()\n"                       # 6
        "        e = torch.nonzero(x)\n"              # 7
        "        f = torch.where(x > 0)\n"            # 8
        "        m = (x > 0) & (x < 3)\n"
        "        x[m] = 0\n"                          # 10
        "        while x.max() > 0:\n"                # 11
        "            x = x - 1\n"
        "        y = x.shape[0] if x.is_cuda else 0\n"  # static: clean
        "        if cfg.memory.enabled:\n"            # static: clean
        "            y = y + 1\n"
        "        return a, b, c, e, f, y\n"
        "    return step\n"
        "def host(x: torch.Tensor):\n"
        "    return x.item()\n"                       # not in the tick: clean
    )
    lines = sorted(f.line for f in lint.lint_paths([p]) if f.rule == "LC101")
    assert lines == [4, 5, 6, 7, 8, 10, 11], lines


def test_cachekey_field_shapes_the_ports_trace():
    """``schedule.mmpp_hi_factor`` (the JAX fixture's field) does change
    the port's recorded op trace under bursty: the fixture is not vacuous."""
    cfg = trace_audit.audit_config()
    base = trace_audit._base_state(cfg)
    bursty = SCENARIOS["bursty"]
    hi = trace_audit.perturb_field(bursty, "schedule.mmpp_hi_factor")
    fp = [trace_audit.fingerprint(trace_audit.record_tick(cfg, sc, base)[0]) for sc in (bursty, hi)]
    assert fp[0] != fp[1]
    findings = _run_targets(FIXTURES / "bad_signature_cachekey.py")
    assert [f.rule for f in findings] == ["LC201"]
    assert "mmpp_hi_factor" in findings[0].message


def test_recorded_tick_does_not_depend_on_the_first_call():
    """With the histogram edges' table emptied, as in a fresh process, two
    recordings of one tick are alike: the table fills in the warm-up, not
    in the first trace, so the fingerprints above compare ticks and not
    call order."""
    from repro_torch.core import state

    cfg = trace_audit.audit_config()
    state._edges_on.cache_clear()
    fp = [trace_audit.fingerprint(trace_audit.record_tick(cfg, SCENARIOS["storm"])[0])
          for _ in range(2)]
    assert fp[0] == fp[1]


def test_config_declaration_check_catches_compare_false(monkeypatch):
    @dataclasses.dataclass(frozen=True)
    class BrokenConfig:
        n: int = 4
        debug_tag: str = dataclasses.field(default="x", compare=False)

    monkeypatch.setattr(trace_audit, "_CONFIG_CLASSES", (BrokenConfig,))
    findings = trace_audit.check_config_declarations()
    assert [f.rule for f in findings] == ["LC201"]
    assert "debug_tag" in findings[0].message


# ---------------------------------------------------------------------------
# clean tree: zero false positives, and not vacuous
# ---------------------------------------------------------------------------


def test_lint_clean_on_tree():
    findings = filter_suppressed(lint.run_lint(PKG, tests_root=TESTS, repo_root=ROOT))
    assert findings == [], [str(f) for f in findings]


def test_kernel_contract_clean_on_tree():
    findings = filter_suppressed(kernel_contract.run_kernel_contract())
    assert findings == [], [str(f) for f in findings]


def test_trace_audit_clean_on_tree():
    findings = filter_suppressed(trace_audit.run_trace_audit())
    assert findings == [], [str(f) for f in findings]


def test_tick_set_covers_the_hot_path():
    idx = lint.ProjectIndex(sorted(PKG.rglob("*.py")), PKG.parent)
    traced = {(Path(k).name, q) for k, q in idx.traced}
    for expect in [
        ("engine.py", "make_step.step"),
        ("engine.py", "_inject_arrivals"),
        ("draws.py", "TorchDraws.tick"),
        ("engine_mesh.py", "MeshPlane.arb_rounds"),
        ("engine_mesh.py", "zone_block"),
        ("hotpath.py", "survival_scan"),
        ("hotpath.py", "bitmap_fit_rounds"),
        ("hotpath.py", "bitmap_fit_rounds_blocked"),
        ("arbiter.py", "arbitrate_rounds"),
        ("arbiter.py", "_admissions"),
        ("hotpath.py", "utility_topk_address"),
        ("hotpath.py", "zone_aggregate_members"),
        ("hotpath.py", "node_view"),
        ("ops.py", "launch"),
    ]:
        assert expect in traced, expect
    # the tile entries are on no tick: addressing and refresh are one entry
    # each; nor are the one-round entries: both ticks run their rounds in one
    for off in ("utility_topk", "zone_aggregate", "bitmap_fit", "bitmap_fit_blocked"):
        assert ("hotpath.py", off) not in traced, off
    assert ("arbiter.py", "arbitrate") not in traced
    assert not any(q in ("summarize", "LaminarEngine.run", "LaminarEngine.init") for _, q in traced)


def test_trace_records_every_hot_path_entry():
    ops, *_ = trace_audit.record_tick(trace_audit.audit_config(), SCENARIOS["storm"])
    kernels = [op.name for op in ops if op.name.startswith("kernel.")]
    # one launch each: the flat tick's arbitration rounds are one
    # bitmap_fit_rounds, its addressing step one utility_topk_address, its
    # TEG refresh one zone_aggregate_members, its true node view one node_view
    assert sorted(kernels) == ["kernel.bitmap_fit_rounds", "kernel.node_view",
                               "kernel.survival_scan", "kernel.utility_topk_address",
                               "kernel.zone_aggregate_members"]
    assert not any(op.sync for op in ops)


# ---------------------------------------------------------------------------
# launch plans and the kernel plane
# ---------------------------------------------------------------------------


def _plan(grid=4, block=256, first=0, guarded=True, static=0, dynamic=0, scratch=None,
          cluster=1, nonportable=False):
    ops = (Operand("x", 1000, 256, first=first), Operand("y", 1000, 256, write=True))
    carve = scratch or ()
    return LaunchPlan(
        entry="toy", source="toy",
        launches=(Launch("toy_kernel", grid, block, ops, guarded, dynamic, static, cluster,
                         nonportable),),
        outputs=(Output("y", (1000,), torch.float32),),
        scratch_words=10 if carve else 0, scratch=carve,
    )


@pytest.mark.parametrize("kw,rules", [
    (dict(), []),  # 4 guarded blocks of 256 over 1000 rows: exact cover
    (dict(grid=3), ["LC301", "LC301"]),
    (dict(guarded=False), ["LC302", "LC302"]),
    (dict(first=-256, grid=5), ["LC302"]),  # before the start: no guard covers it
    (dict(static=64 * 1024), ["LC303"]),
    (dict(dynamic=228 * 1024), ["LC303"]),
    (dict(block=2048), ["LC303"]),
    (dict(grid=0), ["LC301"]),
    (dict(scratch=(Carve("a", 0, 6), Carve("b", 5, 5))), ["LC302"]),  # overlap
    (dict(scratch=(Carve("a", 0, 6), Carve("b", 6, 5))), ["LC302"]),  # past the end
    (dict(grid=8, cluster=8), []),  # the portable cluster
    (dict(grid=16, cluster=16), ["LC303"]),  # past 8 without the non-portable attribute
    (dict(grid=16, cluster=16, nonportable=True), []),
    (dict(grid=32, cluster=32, nonportable=True), ["LC303"]),  # past 16
    (dict(grid=6, cluster=4), ["LC303"]),  # a partial cluster
    (dict(grid=16, cluster=16, dynamic=228 * 1024), ["LC303", "LC303"]),  # each CTA's budget too
])
def test_check_plan_rules(kw, rules):
    assert sorted(f.rule for f in kernel_contract.check_plan(_plan(**kw))) == rules


def test_audit_launch_plan_raises_without_launches():
    with pytest.raises(RuntimeError, match="no launch"):
        kernel_contract.audit_launch_plan(dataclasses.replace(_plan(), launches=()))


def test_main_path_geometries_match_init_numpy():
    """EXP5_GEOM's zone block is the one init_numpy lays out at seed 0."""
    from repro_torch.core.state import init_numpy
    from repro_torch.profile_tick import exp5_config

    cfg = exp5_config(False, full=True, ticks=10)
    Z, M = init_numpy(cfg, 0)["zmember"].shape
    g = kernel_contract.EXP5_GEOM
    assert (g["N"], g["P"], g["K"], g["Z"], g["M"]) == (
        cfg.num_nodes, cfg.probe_capacity, cfg.candidate_k, Z, M)


def test_survival_scan_plan_scratch_and_slots():
    """One launch of one cluster at every shape; its shared memory, scratch
    and the slots a thread holds; an empty table; shapes past the limits."""
    from repro_torch.kernels.survival_scan import plan as sp

    p = sp.plan(1029, 37, True)
    (L,) = p.launches
    assert [L.kernel] == list(sp.KERNELS)
    assert (L.grid, L.block, L.cluster, L.cluster_nonportable) == (16, 1024, 16, True)
    assert L.static_smem == 0 and L.dynamic_smem == sp.smem_bytes(37)
    assert p.scratch_words == sp.scratch_words(1029, 37) == 4 * 1029 + 37
    assert [(c.name, c.offset, c.words) for c in p.scratch] == [
        ("ent", 0, 4 * 1029), ("info", 4 * 1029, 37)]
    assert sp.launch_args(1029, 37, False) == (16, 1024, 16, 1, sp.smem_bytes(37), 1)
    assert sp.pack(p) == sp.launch_args(1029, 37, True)
    for g in kernel_contract.GEOMETRIES.values():
        (L,) = sp.plan(g["P"], g["N"], True).launches
        assert L.dynamic_smem <= kernel_contract.PER_BLOCK["smem"]
        assert L.operands[0].rows_per_block * L.grid >= g["P"]
    assert sp.launch_args(131072, 65536, True)[-1] == sp.MAX_STEPS  # Exp7: 8 slots a thread
    empty = sp.plan(0, 37, True)  # an empty table: one launch still writes pressure = base
    assert len(empty.launches) == 1 and empty.scratch_words == 37  # the mask words
    assert sp.launch_args(0, 37, True)[-1] == 0
    assert not kernel_contract.check_plan(empty)
    with pytest.raises(ValueError, match="131072"):
        sp.plan(sp.MAX_SLOTS + 1, 37, True)
    with pytest.raises(ValueError, match=str(sp.max_nodes())):
        sp.plan(1029, sp.max_nodes() + 1, True)
    assert sp.smem_bytes(sp.max_nodes()) <= sp.SMEM_LIMIT < sp.smem_bytes(sp.max_nodes() + 16)


def test_bitmap_fit_rounds_plan_and_limits():
    """One launch of one 16-CTA cluster, 32 KiB of static shared memory (the
    warps' gathered keys), R keys a node of scratch, the instantiation for
    the node's 64-bit words; shapes past the kernel's limits are refused with
    the limit in the message."""
    from repro_torch.kernels.bitmap_fit import plan as bp

    p = bp.rounds_plan(1029, 37, 2, 3, 64)
    (L,) = p.launches
    assert L.kernel == "bitmap_fit_rounds_kernel<1>" and L.kernel in bp.KERNELS
    assert (L.grid, L.block, L.cluster, L.cluster_nonportable) == (16, 512, 16, True)
    assert L.static_smem == bp.ROUND_STATIC_SMEM == 32 * 1024 and L.dynamic_smem == 0
    assert p.scratch_words == bp.rounds_scratch_words(37, 3) == 2 * 37 * 3
    assert [(c.name, c.offset, c.words) for c in p.scratch] == [("keys", 0, 222)]
    assert [(o.name, o.shape) for o in p.outputs] == [
        ("winner", (3, 37)), ("feas", (3, 37)), ("alloc", (3, 37, 2)), ("round", (1029,)),
        ("admit", (1029,))]
    assert bp.pack(p) == (16, 512, 16, 1, 65, 3)
    assert not kernel_contract.check_plan(p)
    assert bp.rounds_plan(100, 9, 8, 3, 256).launches[0].kernel == "bitmap_fit_rounds_kernel<4>"
    assert bp.rounds_plan(100, 9, 3, 3, 80).launches[0].kernel == "bitmap_fit_rounds_kernel<2>"
    for g in kernel_contract.GEOMETRIES.values():
        (L,) = bp.rounds_plan(g["P"], g["N"], g["W"], 3, g["A"]).launches
        assert L.operands[0].rows_per_block * L.grid >= g["P"]
        assert L.operands[3].rows_per_block * L.grid >= g["N"]
    with pytest.raises(ValueError, match="1 to 8"):
        bp.rounds_plan(100, 9, 9, 3, 288)
    with pytest.raises(ValueError, match="1 to 64"):
        bp.rounds_plan(100, 9, 2, 3, 65)
    with pytest.raises(ValueError, match="at least one node"):
        bp.rounds_plan(100, 0, 2, 3, 64)
    with pytest.raises(ValueError, match="0 to 8"):
        bp.rounds_plan(100, 9, 2, 9, 64)


def test_plans_are_cached_by_shape():
    from repro_torch.kernels import ENTRIES

    args = (torch.zeros(300, 2, dtype=torch.int32), torch.zeros(300, dtype=torch.int32),
            torch.zeros(300, dtype=torch.bool))
    assert ENTRIES["bitmap_fit"].plan(*args) is ENTRIES["bitmap_fit"].plan(*args)


def test_the_entries_are_the_one_list_of_the_kernels():
    """``kernels.ENTRIES`` is the one list of the hand-written kernels: its
    sources are ``csrc/*.cu`` (what the build compiles), every
    ``__global__`` a package's ``plan.KERNELS`` declares is an entry's and
    every entry's is its package's, each wrapper is found on its module by
    its name (the custom op's batching rule and the recording patch look it
    up there), and the profiler's and the graph census's lists are the
    table's."""
    import importlib

    from repro_torch import kernel_bench, profile_tick
    from repro_torch.kernels import ENTRIES, HAND_WRITTEN, LOCKSTEP, SOURCES, _build

    assert sorted(SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.NAMES) == sorted(SOURCES)
    declared = {(src, k.split("<")[0]) for src in SOURCES
                for k in importlib.import_module(f"repro_torch.kernels.{src}.plan").KERNELS}
    assert declared == {(e.source, e.kernel) for e in ENTRIES.values()}
    for name, e in ENTRIES.items():
        assert getattr(importlib.import_module(e.wrapper.__module__), name) is e.wrapper
        assert isinstance(e.wrapper.launches, int)
    assert LOCKSTEP == ("bitmap_fit_rounds", "utility_topk_address", "zone_aggregate_members",
                        "survival_scan", "node_view")
    assert all(ENTRIES[name].tick for name in LOCKSTEP)
    assert profile_tick.HAND_WRITTEN == HAND_WRITTEN == tuple(dict.fromkeys(
        e.kernel for e in ENTRIES.values()))
    # a graph's kernel nodes, mangled as cuFuncGetName gives them, by entry
    names = [f"_ZN12_GLOBAL__N_1{len(k)}{k}ILi1EEEvPKi" for k in HAND_WRITTEN]
    assert kernel_bench.tick_entries(names + ["ncclDevKernel_AllGather_RING_LL"]) == {
        "bitmap_fit_kernel": 1, "bitmap_fit_rounds": 1, "bitmap_fit_rounds_blocked": 1,
        "utility_topk_kernel": 1, "utility_topk_address": 1, "zone_aggregate_members": 1,
        "survival_scan": 1, "node_view": 1, "block_copy_kernel": 1}


def test_block_copy_cpu_route_is_the_interpreter():
    x = torch.arange(1024, dtype=torch.float32)
    good = copy_plan.good_plan(1024, 128)
    torch.testing.assert_close(block_copy(x, good), x, rtol=0, atol=0)
    short = block_copy(x, copy_plan.plan(1024, 128, 7))  # a grid one block short
    assert bool(torch.isnan(short[896:]).all()) and not bool(torch.isnan(short[:896]).any())
    hog = copy_plan.plan(1024, 1024, 1)
    torch.testing.assert_close(block_copy_ref(x, hog), x, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax_targets():
    return {t.__name__: t for t in _targets(JAX_FIXTURE)}


@pytest.mark.parametrize("target", ["tail_dropping_grid", "index_map_overshoot", "vmem_over_budget"])
def test_grid_fixture_rules_match_the_jax_analyzer(target):
    want = {f.rule for f in _jax_targets()[target]()}
    ours = {t.__name__: t for t in _targets(FIXTURES / "bad_launch_tail.py")}
    got = {f.rule for f in ours[target]()}
    assert got == want, (target, got, want)


def _jax_copy(grid, in_map, block, n):
    kernel = _module(JAX_FIXTURE, "_jax_bad_blockspec_tail")._copy_kernel
    return pl.pallas_call(
        kernel,
        grid=(grid,),
        in_specs=[pl.BlockSpec((block,), in_map)],
        out_specs=pl.BlockSpec((block,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.float32),
        interpret=True,
    )


@pytest.mark.parametrize("label,grid,offset", [
    ("good", 8, 0), ("tail_dropping_grid", 7, 0), ("index_map_overshoot", 8, 1),
])
def test_plan_interpreter_matches_pallas_interpret(label, grid, offset):
    n, block = 1024, 128
    x = np.random.default_rng(7).normal(size=n).astype(np.float32)
    want = np.asarray(_jax_copy(grid, lambda i: (i + offset,), block, n)(jnp.asarray(x)))
    got = kernel_contract.interpret(copy_plan.plan(n, block, grid, offset), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)  # NaN where both are NaN
    if label == "tail_dropping_grid":
        assert np.isnan(want[-block:]).all() and not np.isnan(want[:-block]).any()


# ---------------------------------------------------------------------------
# suppression directives and the rule table
# ---------------------------------------------------------------------------


def test_suppression_directive(tmp_path):
    src = (FIXTURES / "bad_config_mutation.py").read_text()
    marked = src.replace(
        "cfg.num_nodes = 4096  # LC104: attribute store on a config",
        "cfg.num_nodes = 4096  # laminar-check: ignore[LC104]",
    )
    p = tmp_path / "suppressed.py"
    p.write_text(marked)
    findings = filter_suppressed(lint.lint_paths([p]))
    assert [f.rule for f in findings] == ["LC104"]
    assert "object.__setattr__" in findings[0].message


def test_no_suppress_reports_everything(tmp_path):
    p = tmp_path / "suppressed.py"
    p.write_text("def f(cfg):\n    # laminar-check: ignore[LC104]\n    cfg.n = 1\n")
    assert filter_suppressed(lint.lint_paths([p])) == []
    assert [f.rule for f in lint.lint_paths([p])] == ["LC104"]


def test_readme_rule_table_in_sync():
    # the port section's row per rule: `| LC101 | lint | <summary> |`
    readme = (ROOT / "README.md").read_text()
    section = readme[readme.index("python -m repro_torch.analysis"):]
    for rid, rule in RULES.items():
        assert f"| {rid} | {rule.plane} | {rule.summary} |" in section, rid


def test_finding_json_roundtrip():
    f = Finding(rule="LC301", message="m", file="a.cu", line=3)
    j = f.to_json()
    assert (j["rule"], j["plane"], j["file"], j["line"]) == ("LC301", "kernel", "a.cu", 3)
    assert "a.cu:3" in str(f)


# ---------------------------------------------------------------------------
# CLI contract, with JAX blocked from import
# ---------------------------------------------------------------------------

_BLOCKED_CLI = (
    "import sys, runpy\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv = ['laminar-check'] + sys.argv[1:]\n"
    "runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-c", _BLOCKED_CLI, *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )


def test_cli_clean_on_tree_with_json(tmp_path):
    out = tmp_path / "findings.json"
    r = _cli("--json", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 findings" in r.stdout
    payload = json.loads(out.read_text())
    assert payload["findings"] == []
    assert set(payload["rules"]) == set(RULES)
    assert all(set(v) == {"plane", "summary", "rationale"} for v in payload["rules"].values())


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_cli_exits_nonzero_on_fixture(tmp_path, name):
    out = tmp_path / "findings.json"
    r = _cli(str(FIXTURES / name), "--json", str(out))
    assert r.returncode == 1, r.stdout + r.stderr
    fired = {f["rule"] for f in json.loads(out.read_text())["findings"]}
    want = STATIC_FIXTURES.get(name, set()) | DYNAMIC_FIXTURES.get(name, set())
    assert want <= fired, (name, fired)
    assert all(set(f) == {"rule", "plane", "message", "file", "line"}
               for f in json.loads(out.read_text())["findings"])


def test_cli_usage_error_exits_2():
    r = _cli("--plane", "nope")
    assert r.returncode == 2
