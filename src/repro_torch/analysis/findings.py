"""Finding/Rule model + the rule catalog shared by the port's three planes.

The port's own copy of ``repro.analysis.findings``: the same ``Finding`` and
``Rule``, the same rule ids, the same ``# laminar-check: ignore[RULE]``
directive, with each rule's meaning in the port. The CLI
(``python -m repro_torch.analysis``) collects findings from every plane,
drops the suppressed ones, serializes the rest to JSON and exits non-zero
when any survive. The README's rule table of the port is kept in sync with
this registry by ``tests/test_torch_analysis.py``.

Suppression: a finding anchored at ``file:line`` is suppressed when that
line (or the comment-only line above it) carries
``# laminar-check: ignore[RULE]`` with a matching rule id. Suppressions are
meant to be rare and carry an inline reason next to the directive.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = [
    "Finding",
    "Rule",
    "RULES",
    "filter_suppressed",
    "suppressed_rules_on_line",
]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered check: identity, plane, and what it guards against."""

    id: str
    plane: str  # "trace" | "kernel" | "lint"
    summary: str
    rationale: str  # which invariant / shipped bug this protects


@dataclasses.dataclass
class Finding:
    """One concrete violation, anchored to a source location when known."""

    rule: str
    message: str
    file: Optional[str] = None
    line: Optional[int] = None

    def location(self) -> str:
        if self.file is None:
            return "<project>"
        return f"{self.file}:{self.line}" if self.line else self.file

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "plane": RULES[self.rule].plane if self.rule in RULES else "?",
            "message": self.message,
            "file": self.file,
            "line": self.line,
        }

    def __str__(self) -> str:
        return f"{self.location()}: {self.rule}: {self.message}"


_RULE_LIST = [
    # ---- plane 3: AST lint over src/repro_torch ---------------------------
    Rule(
        id="LC101",
        plane="lint",
        summary="host sync inside the tick (`if`/`while`/`bool()`/`int()`/`.item()`/`.tolist()`/`.cpu()`/`.numpy()` on a tensor, `torch.nonzero`, boolean-mask indexing)",
        rationale=(
            "The tick only enqueues work on the card: a host read of a "
            "device value stalls the launch queue and makes the tick "
            "impossible to capture in a CUDA graph. The "
            "trace plane checks the same on the recorded aten ops."
        ),
    ),
    Rule(
        id="LC102",
        plane="lint",
        summary="numpy applied to a tensor inside the tick",
        rationale=(
            "numpy on a CUDA tensor copies it to the host (a sync) or "
            "fails; inside the tick numpy may only touch host data such as "
            "the config and the pre-drawn mmpp burst states."
        ),
    ),
    Rule(
        id="LC103",
        plane="lint",
        summary="kernel ops.py entry lacking a `_ref` twin or a `tests/test_torch_*.py` reference",
        rationale=(
            "Every hand-written kernel takes its plain version on the CPU "
            "and is held to it by the tests; an untwinned entry has no CPU "
            "route and no parity net."
        ),
    ),
    Rule(
        id="LC104",
        plane="lint",
        summary="config object mutated after construction",
        rationale=(
            "Configs are frozen values the tick reads as static Python; "
            "mutation (object.__setattr__ / attribute store) desynchronizes "
            "a built step, its plans and its draws from the config it "
            "claims to run."
        ),
    ),
    # ---- plane 1: aten trace audit of one tick ----------------------------
    Rule(
        id="LC201",
        plane="trace",
        summary="config field alters the tick's recorded op trace but not the cache key",
        rationale=(
            "A compiled tick (a CUDA graph, A 8c) is reusable only while "
            "its key covers every field that shapes the recorded ops: "
            "ScenarioConfig.signature(), and the frozen config value. A "
            "name-only scenario key was once exactly this bug in the reference."
        ),
    ),
    Rule(
        id="LC202",
        plane="trace",
        summary="float64 tensor in the tick, or a state leg whose dtype changes across it",
        rationale=(
            "The tick is float32 end to end; a float64 value means host "
            "numpy or a Python float leaked into a tensor, and a state leg "
            "that changes dtype breaks the next tick and graph capture."
        ),
    ),
    Rule(
        id="LC203",
        plane="trace",
        summary="float32 value narrowed to bf16/f16 inside the tick",
        rationale=(
            "Accumulators (pressure, patience, metrics) narrowed to "
            "bf16/f16 lose the bit-for-bit CPU-vs-CUDA and port-vs-JAX "
            "parity the tests enforce."
        ),
    ),
    Rule(
        id="LC204",
        plane="trace",
        summary="CUDA route and CPU route of a hot-path entry disagree on output shape/dtype",
        rationale=(
            "The device of the tensors picks the kernel or its plain "
            "version; both must give the same shapes and dtypes, or the "
            "tick specializes per device and CPU-vs-CUDA parity is lost."
        ),
    ),
    # ---- plane 2: launch-plan contracts of the Hopper kernels -------------
    Rule(
        id="LC301",
        plane="kernel",
        summary="launch grid does not cover every element of an operand",
        rationale=(
            "A grid one block short leaves output rows unwritten (garbage) "
            "or input rows unread (silently dropped probes/nodes); the "
            "blocks of a plan must cover each operand."
        ),
    ),
    Rule(
        id="LC302",
        plane="kernel",
        summary="a block reaches past an operand without a guard, or a scratch carve-out leaves its scratch",
        rationale=(
            "CUDA does not clamp: an unguarded block past the end reads or "
            "writes another allocation. Threads past an extent must return "
            "first, and survival_scan's carve-outs must stay inside "
            "survival_scan_scratch_words."
        ),
    ),
    Rule(
        id="LC303",
        plane="kernel",
        summary="per-block budget or cluster limit exceeded (static smem > 48 KiB, static + dynamic > 227 KiB, threads > 1024; cluster > 8 CTAs without the non-portable attribute, > 16, or a grid of partial clusters)",
        rationale=(
            "An H100 block has at most 227 KiB of shared memory (over 48 "
            "KiB only as opted-in dynamic memory) and 1024 threads, and a "
            "cluster at most 8 CTAs (16 with the non-portable attribute); "
            "a launch over any of them is refused and never runs."
        ),
    ),
    Rule(
        id="LC304",
        plane="kernel",
        summary="plan outputs and `_ref` twin outputs differ in shape/dtype",
        rationale=(
            "The wrapper allocates its outputs from the plan and the CPU "
            "route returns the `_ref` twin's; if they diverge, the parity "
            "tests compare different quantities."
        ),
    ),
]

RULES: Dict[str, Rule] = {r.id: r for r in _RULE_LIST}

_IGNORE_RE = re.compile(r"#\s*laminar-check:\s*ignore\[([A-Z0-9,\s]+)\]")


def suppressed_rules_on_line(text: str) -> List[str]:
    """Rule ids named by a ``# laminar-check: ignore[...]`` directive."""
    m = _IGNORE_RE.search(text)
    if not m:
        return []
    return [tok.strip() for tok in m.group(1).split(",") if tok.strip()]


def _is_suppressed(f: Finding, source_lines: List[str]) -> bool:
    if f.line is None or not 1 <= f.line <= len(source_lines):
        return False
    here = suppressed_rules_on_line(source_lines[f.line - 1])
    # the line-above form only counts on a comment-only line, so a trailing
    # directive on one statement cannot spill onto the next
    above: List[str] = []
    if f.line >= 2 and source_lines[f.line - 2].lstrip().startswith("#"):
        above = suppressed_rules_on_line(source_lines[f.line - 2])
    return f.rule in here or f.rule in above


def filter_suppressed(findings: Iterable[Finding]) -> List[Finding]:
    """Drop findings whose anchor line carries a matching ignore directive."""
    out: List[Finding] = []
    cache: Dict[str, List[str]] = {}
    for f in findings:
        if f.file is not None:
            if f.file not in cache:
                try:
                    cache[f.file] = Path(f.file).read_text().splitlines()
                except OSError:
                    cache[f.file] = []
            if _is_suppressed(f, cache[f.file]):
                continue
        out.append(f)
    return out
