"""Plane 2: launch-plan contracts of the port's hand-written kernels.

Every kernel launch of the port runs under a declared plan
(``repro_torch.kernels.launch_plan``): the wrapper builds it, allocates its
outputs from it and passes grid and block to the C launcher. This plane
re-derives the contract from the plans the wrappers would use, for each
entry at the reference geometries of ``repro.analysis.kernel_contract``
(production and ragged) and at the main paths' shapes (Exp5 and Exp7's top
cell), and checks, per launch and operand:

  * LC301 — the grid's blocks cover every row of the operand;
  * LC302 — no block reaches past the operand unless its threads are
    guarded, and every scratch carve-out stays inside the scratch (for
    ``survival_scan``, inside ``survival_scan_scratch_words``) without
    overlapping another;
  * LC303 — the H100's per-block budget: static shared memory <= 48 KiB,
    static + dynamic <= 227 KiB (the opt-in maximum) for every CTA of a
    cluster, threads <= 1024; and its cluster limits: at most 8 CTAs (the
    portable size), 16 with the non-portable attribute, and a grid of whole
    clusters; a batched launch's seed axis within the grid's second
    dimension (65 535; a cluster launch: 2^31 - 1 CTAs along x);
  * LC304 — the plan's outputs have the shapes and dtypes of the ``_ref``
    twin's outputs on the CPU.

The lockstep tick's five entries are checked at ``SEEDS`` seeds too (their
arguments with a leading seed axis): their operands are one seed's, so
coverage and bounds are those of the plan without it, and their outputs
carry the seed axis.

Nothing is launched: plans are plain data, and the ``_ref`` twins run on
``meta`` tensors (shapes only). ``audit_launch_plan`` checks one plan, the
counterpart of ``audit_pallas_fn`` for the fixtures; :func:`interpret` is the
plan interpreter, the port's ``interpret=True`` for block-copy plans.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import ENTRIES
from repro_torch.kernels.block_copy.ref import block_copy_ref
from repro_torch.kernels.launch_plan import Launch, LaunchPlan, Operand

__all__ = [
    "GEOMETRIES",
    "PER_BLOCK",
    "audit_launch_plan",
    "check_plan",
    "compare_output_avals",
    "interpret",
    "kernel_suite",
    "run_kernel_contract",
]

# One H100 block (CUDA's limits for compute capability 9.0): 48 KiB of
# static shared memory, 227 KiB with opted-in dynamic memory, 1024 threads;
# a thread-block cluster of at most 8 CTAs, 16 after
# cudaFuncAttributeNonPortableClusterSizeAllowed.
PER_BLOCK: Dict[str, int] = {
    "static_smem": 48 * 1024,
    "smem": 227 * 1024,
    "threads": 1024,
    "cluster_portable": 8,
    "cluster_max": 16,
}

# The JAX analyzer's geometries (repro/analysis/kernel_contract.py:62-63),
# and the main paths' shapes of chip_smoke.py phase 2: Exp5 and Exp7's top
# cell, Z and M as init_numpy(cfg, 0) lays the zones out.
PROD_GEOM = dict(N=2048, W=2, A=64, P=8192, K=8, Z=8, M=256)
RAGGED_GEOM = dict(N=1500, W=2, A=64, P=1000, K=5, Z=5, M=33)
EXP5_GEOM = dict(N=5000, W=2, A=64, P=65536, K=8, Z=20, M=301)
EXP7_GEOM = dict(N=65536, W=2, A=64, P=131072, K=8, Z=253, M=307)
GEOMETRIES = {"prod": PROD_GEOM, "ragged": RAGGED_GEOM, "exp5": EXP5_GEOM, "exp7": EXP7_GEOM}
# the seed axis of the lockstep tick's entries here (benchmarks/common.py run_seeds runs 4)
SEEDS = 3
MAX_GRID_Y = 65535
MAX_GRID_X = 2**31 - 1


def interpret(plan: LaunchPlan, x: torch.Tensor) -> torch.Tensor:
    """Run a block-copy plan block by block with torch ops, as Pallas's
    interpret mode runs a ``pallas_call`` on the CPU."""
    return block_copy_ref(x, plan)


def _source(plan: LaunchPlan) -> str:
    return f"src/repro_torch/csrc/{plan.source}.cu"


# ---------------------------------------------------------------------------
# per-plan checks (LC301 / LC302 / LC303)
# ---------------------------------------------------------------------------


def _check_operand(L: Launch, op: Operand, ctx: str, file: str) -> List[Finding]:
    out: List[Finding] = []
    label = f"{'output' if op.write else 'input'} {op.name}"
    lo = op.first
    hi = op.first + L.grid * op.rows_per_block  # blocks are adjacent: one span
    seen = max(0, min(hi, op.rows) - max(lo, 0))
    if seen < op.rows:
        first_gap = 0 if lo > 0 else max(hi, 0)
        out.append(Finding(
            rule="LC301",
            message=(
                f"{ctx}: grid {L.grid} x {op.rows_per_block} rows leaves "
                f"{op.rows - seen}/{op.rows} rows of {label} unvisited — first "
                f"uncovered row {first_gap}"
            ),
            file=file,
        ))
    if (lo < 0 or hi > op.rows) and not (L.guarded and lo >= 0):
        out.append(Finding(
            rule="LC302",
            message=(
                f"{ctx}: blocks reach rows [{lo}, {hi}) of {label} "
                f"({op.rows} rows) with no guard — a block past the end "
                "touches another allocation"
            ),
            file=file,
        ))
    return out


def _check_scratch(plan: LaunchPlan, ctx: str, file: str) -> List[Finding]:
    out: List[Finding] = []
    spans = sorted((c.offset, c.offset + c.words, c.name) for c in plan.scratch)
    for lo, hi, name in spans:
        if lo < 0 or hi > plan.scratch_words:
            out.append(Finding(
                rule="LC302",
                message=(
                    f"{ctx}: scratch carve-out {name} [{lo}, {hi}) leaves the "
                    f"{plan.scratch_words} words of scratch"
                ),
                file=file,
            ))
    for (lo1, hi1, a), (lo2, _, b) in zip(spans, spans[1:]):
        if lo2 < hi1:
            out.append(Finding(
                rule="LC302",
                message=f"{ctx}: scratch carve-outs {a} and {b} overlap at word {lo2}",
                file=file,
            ))
    return out


def _cluster_faults(L: Launch) -> List[str]:
    portable, most = PER_BLOCK["cluster_portable"], PER_BLOCK["cluster_max"]
    if not 1 <= L.cluster <= most:
        return [f"cluster of {L.cluster} CTAs outside 1..{most}"]
    out = []
    if L.cluster > portable and not L.cluster_nonportable:
        out.append(f"cluster of {L.cluster} CTAs > the portable {portable} without the "
                   "non-portable cluster attribute")
    if L.grid % L.cluster:
        out.append(f"grid {L.grid} is not a whole number of clusters of {L.cluster}")
    if L.seeds < 1:
        out.append(f"{L.seeds} seeds: a launch runs at least one")
    elif L.cluster > 1 and L.grid * L.seeds > MAX_GRID_X:
        out.append(f"{L.seeds} seeds x grid {L.grid} > {MAX_GRID_X} CTAs along x")
    elif L.cluster == 1 and L.seeds > MAX_GRID_Y:
        out.append(f"{L.seeds} seeds > the grid's second dimension, {MAX_GRID_Y}")
    return out


def check_plan(
    plan: LaunchPlan, budget_bytes: Optional[int] = None, context: str = ""
) -> List[Finding]:
    """LC301/LC302/LC303 over every launch of one plan. ``budget_bytes``
    replaces the 227 KiB bound of a block's shared memory."""
    budget = PER_BLOCK["smem"] if budget_bytes is None else budget_bytes
    context = context or plan.entry
    file = _source(plan)
    findings: List[Finding] = []
    for L in plan.launches:
        ctx = f"{context}:{L.kernel}"
        if L.grid < 1:
            findings.append(Finding(
                rule="LC301", message=f"{ctx}: empty grid {L.grid} — kernel never runs", file=file,
            ))
            continue
        for op in L.operands:
            findings.extend(_check_operand(L, op, ctx, file))
        smem = L.static_smem + L.dynamic_smem
        over = []
        if L.static_smem > PER_BLOCK["static_smem"]:
            over.append(f"static shared memory {L.static_smem} B > {PER_BLOCK['static_smem']} B")
        if smem > budget:
            over.append(f"shared memory {smem} B (static {L.static_smem} + dynamic "
                        f"{L.dynamic_smem}) > the {budget} B budget")
        if not 1 <= L.block <= PER_BLOCK["threads"]:
            over.append(f"block of {L.block} threads outside 1..{PER_BLOCK['threads']}")
        over.extend(_cluster_faults(L))
        for what in over:
            findings.append(Finding(rule="LC303", message=f"{ctx}: {what}", file=file))
    findings.extend(_check_scratch(plan, context, file))
    return findings


def audit_launch_plan(
    plan: LaunchPlan, name: str = "<plan>", budget_bytes: Optional[int] = None
) -> List[Finding]:
    """Check one plan, as ``audit_pallas_fn`` checks one ``pallas_call``.

    Raises if the plan records no launch at all (a checker wiring fault,
    not a code finding)."""
    if not plan.launches:
        raise RuntimeError(f"{name}: the plan records no launch")
    return check_plan(plan, budget_bytes, context=name)


# ---------------------------------------------------------------------------
# LC304: plan outputs vs the _ref twin's
# ---------------------------------------------------------------------------


def _avals(outs: Any) -> List[Tuple[Tuple[int, ...], str]]:
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [(tuple(o.shape), str(o.dtype)) for o in outs]


def compare_output_avals(
    name: str, kernel_out: Any, ref_out: Any, file: Optional[str] = None
) -> List[Finding]:
    """LC304: ``kernel_out`` (a plan's ``Output``s, or tensors) against the
    ``_ref`` twin's outputs."""
    ak, ar = _avals(kernel_out), _avals(ref_out)
    if ak == ar:
        return []
    return [Finding(
        rule="LC304",
        message=f"{name}: plan outputs {ak} != reference outputs {ar}",
        file=file,
    )]


# ---------------------------------------------------------------------------
# the shipped kernel entries
# ---------------------------------------------------------------------------


def kernel_suite(geom: Dict[str, int]) -> List[Tuple[str, tuple, dict, Callable]]:
    """(entry, args, kwargs, ref_fn) for every hot-path entry at ``geom``, on
    ``meta`` tensors; the lockstep tick's entries also with a seed axis
    (``ref_fn`` then the plain version seed by seed)."""
    from repro_torch.kernels.batching import per_seed
    from repro_torch.kernels.bitmap_fit import (
        bitmap_fit_blocked_ref,
        bitmap_fit_ref,
        bitmap_fit_rounds_blocked_ref,
        bitmap_fit_rounds_ref,
    )
    from repro_torch.kernels.node_view import node_view_ref
    from repro_torch.kernels.survival_scan import survival_scan_ref
    from repro_torch.kernels.utility_topk import utility_topk_address_ref, utility_topk_ref
    from repro_torch.kernels.zone_aggregate import zone_aggregate_members_ref, zone_aggregate_ref

    N, W, A, P, K, Z, M = (geom[k] for k in ("N", "W", "A", "P", "K", "Z", "M"))
    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device="meta")

    surv_kw = dict(airlock=True, residual=0.3, watermark=0.9, safe=0.8, t_susp=80, t_surv=240)
    cols = (z((P,), i32), z((P,), i32), z((P,), f32), z((P,), f32), z((P,), i32),
            z((P,), b8), z((P,), i32), z((P,), i32), z((N,), f32), z((), i32))
    # utility_topk_address: the probe columns, the draws, zones, nodes, tick
    address = (*(z((P,), i32) for _ in range(4)), z((P,), f32), z((P,), b8), z((P,), i32),
               z((P,), b8), z((P, K - 1), f32), z((P, K), f32), z((Z,), i32), z((Z,), i32),
               z((N,), i32), z((N,), f32), z((N,), f32), z((N,), f32), z((N,), i32),
               *(z((N,), f32) for _ in range(5)), z((), i32))
    address_kw = dict(gamma=1.0, sigma=0.5, stay_margin=1.0, eval_cost=3.0, bounce_cost=6.0,
                      fastfail_floor=1.0, projection=True, tau=10.0, dt_ms=0.5,
                      degrade_after_ms=50.0, degrade_halflife_ms=50.0)
    def seeds(args):  # the arguments with a seed axis: SEEDS seeds of each
        return tuple(a.expand((SEEDS,) + a.shape) if isinstance(a, torch.Tensor) else a
                     for a in args)

    rounds = (z((P,), i32), z((P,), i32), z((P,), f32), z((P,), i32), z((P,), b8),
              z((N, W), i32), z((N,), b8))
    members = (z((N,), f32), z((N,), f32), z((Z, M), i32), z((Z, M), f32), z((), i32),
               z((Z,), f32), z((Z,), f32))
    return [
        ("bitmap_fit", (z((N, W), i32), z((N,), i32), z((N,), b8)), {}, bitmap_fit_ref),
        ("bitmap_fit_blocked", (z((Z, M, W), i32), z((Z, M), i32), z((Z, M), b8)), {},
         bitmap_fit_blocked_ref),
        ("bitmap_fit_rounds", rounds, dict(rounds=3, atoms=A, policy="best"),
         bitmap_fit_rounds_ref),
        # one rank's block of the zone rows: the whole table at one rank
        ("bitmap_fit_rounds_blocked", (z((P,), i32), z((P,), i32), z((P,), f32), z((P,), i32),
                                       z((P,), b8), z((N, W), i32), z((N,), b8), z((Z, M), i32),
                                       z((Z, M), f32), z((N,), i32)),
         dict(rounds=3, atoms=A, policy="best"), bitmap_fit_rounds_blocked_ref),
        ("utility_topk", (z((P, K), f32), z((P, K), f32), z((P, K), f32), z((P, K), b8), 1.0),
         {}, utility_topk_ref),
        ("utility_topk_address", address, address_kw, utility_topk_address_ref),
        ("zone_aggregate", (z((Z, M), f32), z((Z, M), f32), z((Z, M), f32)), {},
         zone_aggregate_ref),
        ("zone_aggregate_members", members, dict(every=20), zone_aggregate_members_ref),
        ("survival_scan", cols, surv_kw, survival_scan_ref),
        ("survival_scan", cols, dict(surv_kw, airlock=False), survival_scan_ref),
        ("bitmap_fit_rounds", seeds(rounds), dict(rounds=3, atoms=A, policy="best"),
         per_seed(bitmap_fit_rounds_ref)),
        ("utility_topk_address", seeds(address), address_kw, per_seed(utility_topk_address_ref)),
        ("zone_aggregate_members", seeds(members), dict(every=20),
         per_seed(zone_aggregate_members_ref)),
        ("survival_scan", seeds(cols), surv_kw, per_seed(survival_scan_ref)),
        ("node_view", (z((N, W), i32),), dict(atoms=A), node_view_ref),
        ("node_view", seeds((z((N, W), i32),)), dict(atoms=A), per_seed(node_view_ref)),
    ]


def run_kernel_contract(
    budget_bytes: Optional[int] = None,
    progress: Optional[Callable[[str], None]] = None,
) -> List[Finding]:
    """Every entry's plan at every geometry."""
    log = progress or (lambda m: None)
    findings: List[Finding] = []
    for geom_name, geom in GEOMETRIES.items():
        for name, args, kw, ref_fn in kernel_suite(geom):
            plan = ENTRIES[name].plan(*args, **kw)
            ctx = (f"{name}[{geom_name}{'' if kw.get('airlock', True) else ', airlock off'}"
                   f"{f', {plan.seeds} seeds' if plan.seeds else ''}]")
            log(f"kernel: {ctx}")
            if not plan.launches:
                raise RuntimeError(f"{ctx}: the plan records no launch")
            findings.extend(check_plan(plan, budget_bytes, context=ctx))
            findings.extend(
                compare_output_avals(ctx, plan.outputs, ref_fn(*args, **kw), file=_source(plan))
            )
    return findings
