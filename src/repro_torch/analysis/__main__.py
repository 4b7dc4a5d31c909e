"""laminar-check for the PyTorch port: three planes, one entry point.

Planes (rule catalog: ``repro_torch.analysis.findings``, the README's table):

  * ``trace``  — aten trace audit of one tick on the CPU: host syncs, dtype
    hazards, CUDA-route (plan) vs CPU-route output parity, scenario cache-key
    completeness (every field that changes the recorded ops must change
    ``signature()``);
  * ``kernel`` — launch-plan contracts of the hand-written kernels at the
    reference and main-path geometries: coverage, bounds and guards,
    scratch carve-outs, the H100's per-block budget, plan-vs-``_ref`` outputs;
  * ``lint``   — AST rules over ``src/repro_torch``: host syncs and numpy in
    the tick, kernel entries without a ``_ref`` twin or a test, config
    mutation.

Usage:

    PYTHONPATH=src python -m repro_torch.analysis                 # whole tree
    python -m repro_torch.analysis --plane lint --plane kernel    # subset
    python -m repro_torch.analysis --json findings.json           # CI artifact
    python -m repro_torch.analysis tests/fixtures/torch_analysis/bad_traced_if.py

Exit status: 0 when no findings survive suppression filtering, 1 otherwise
(2 on usage errors). Inline suppressions use
``# laminar-check: ignore[LC101]`` on the flagged line or the line above.

File mode (positional paths) runs the lint over exactly those files and
imports each one: a file that defines ``LAMINAR_CHECK_TARGETS`` (zero-arg
callables returning finding lists) gets them executed, which is how the
fixtures exercise the trace and kernel planes on known-bad code. Runs on the
CPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import List

from repro_torch.analysis.findings import RULES, Finding, filter_suppressed

PKG = Path(__file__).resolve().parent.parent  # src/repro_torch
ROOT = PKG.parent.parent
TESTS = ROOT / "tests"
PLANES = ("lint", "kernel", "trace")


def _progress(verbose: bool):
    if not verbose:
        return None
    t0 = time.time()

    def log(msg: str) -> None:
        print(f"  [{time.time() - t0:6.1f}s] {msg}", file=sys.stderr)

    return log


def run_tree(planes: List[str], verbose: bool) -> List[Finding]:
    findings: List[Finding] = []
    log = _progress(verbose)
    if "lint" in planes:
        from repro_torch.analysis.lint import run_lint

        if log:
            log("lint: src/repro_torch")
        findings.extend(run_lint(PKG, tests_root=TESTS, repo_root=ROOT))
    if "kernel" in planes:
        from repro_torch.analysis.kernel_contract import run_kernel_contract

        findings.extend(run_kernel_contract(progress=log))
    if "trace" in planes:
        from repro_torch.analysis.trace_audit import run_trace_audit

        findings.extend(run_trace_audit(progress=log))
    return findings


def run_files(paths: List[Path], verbose: bool) -> List[Finding]:
    from repro_torch.analysis.lint import lint_paths

    log = _progress(verbose)
    findings = lint_paths(paths)
    for i, path in enumerate(paths):
        spec = importlib.util.spec_from_file_location(f"_laminar_check_target_{i}", path)
        if spec is None or spec.loader is None:
            continue
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except Exception as e:  # fixture import errors are findings, not crashes
            findings.append(Finding(
                rule="LC101",
                message=f"import of {path} failed: {type(e).__name__}: {e}",
                file=str(path),
            ))
            continue
        for target in getattr(mod, "LAMINAR_CHECK_TARGETS", []):
            if log:
                log(f"target: {path.name}:{getattr(target, '__name__', '?')}")
            findings.extend(target())
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__.splitlines()[0]
    )
    ap.add_argument(
        "files", nargs="*", type=Path,
        help="lint only these files (+ run their LAMINAR_CHECK_TARGETS); "
        "default is the whole three-plane tree audit",
    )
    ap.add_argument(
        "--plane", action="append", choices=PLANES,
        help="restrict the tree audit to a plane (repeatable; default all)",
    )
    ap.add_argument("--json", type=Path, help="write findings + catalog JSON")
    ap.add_argument(
        "--no-suppress", action="store_true",
        help="report findings even on lines with ignore directives",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.files:
        missing = [p for p in args.files if not p.is_file()]
        if missing:
            ap.error(f"no such file: {missing[0]}")
        findings = run_files(args.files, args.verbose)
    else:
        findings = run_tree(args.plane or list(PLANES), args.verbose)

    if not args.no_suppress:
        findings = filter_suppressed(findings)

    if args.json:
        payload = {
            "findings": [f.to_json() for f in findings],
            "rules": {
                rid: {"plane": r.plane, "summary": r.summary, "rationale": r.rationale}
                for rid, r in sorted(RULES.items())
            },
        }
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(payload, indent=2) + "\n")

    for f in findings:
        print(f)
    n = len(findings)
    print(f"laminar-check: {n} finding{'s' if n != 1 else ''}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
