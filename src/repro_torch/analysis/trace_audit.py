"""Plane 1: aten trace audit of one engine tick, on the CPU.

Records, with a ``TorchDispatchMode``, every aten op of one tick of
``engine.make_step`` and of the making of that tick's draws
(``TorchDraws.tick``), because a CUDA graph of the tick would capture both.
The hand-written entries (``kernels.ENTRIES``) are stubbed while the
audit runs: each builds the launch plan its wrapper would
build, is recorded as one ``kernel.<entry>`` op, and returns zeros of its
plan's outputs, the counterpart of
``jax.eval_shape`` over ``pallas_call``. The audit so sees the tick as it
runs on the card, not the ``_ref`` internals; the tick has no data-dependent
branch, so the op trace does not depend on the stubbed values. Checks:

  * LC101 — host syncs: ``aten._local_scalar_dense`` (``.item()``,
    ``bool()``, ``int()`` on a tensor), ``aten.nonzero``,
    ``aten.masked_select`` and indexing with a bool index. A dispatch mode
    does not see ``.tolist()``, ``.cpu()`` or ``.numpy()`` on the CPU; the
    lint plane covers those.
  * LC202 / LC203 — a float64 tensor anywhere in the recorded ops, a state
    leg whose dtype changes across the tick, float32 narrowed to bf16/f16.
  * LC204 — per hot-path entry, the stubbed (CUDA route: plan outputs) and
    the plain CPU route agree on output shapes and dtypes; so does the
    whole step.
  * LC201 — the static half is ``check_config_declarations`` (every config
    class frozen, every field in equality). The dynamic half perturbs each
    ``ScenarioConfig`` leaf under a preset that turns it on and compares a
    fingerprint of the recorded op trace (op names, shapes, dtypes, scalar
    arguments) with ``signature()``. In the port the mmpp burst states are
    drawn ahead from numpy; the state of tick 0's segment enters the trace
    as a scalar argument, and so do the schedule's factors.

The audit runs at a tiny geometry (64 nodes, 256 probe slots): the op trace
does not depend on array sizes beyond the recorded shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.core import engine, hotpath, zhaf
from repro_torch.core.config import BaselineConfig, LaminarConfig, MemoryConfig, WorkloadConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.kernels import ENTRIES
from repro_torch.parallel.engine_mesh import zone_block
from repro_torch.workloads.scenario import (
    KINDS,
    SCENARIOS,
    DisruptionConfig,
    ScenarioConfig,
    ScheduleConfig,
)

__all__ = [
    "OpRecorder",
    "audit_config",
    "audit_mode_parity",
    "audit_ops",
    "audit_signature_coverage",
    "check_config_declarations",
    "compare_branch_avals",
    "compare_routes",
    "fingerprint",
    "record_tick",
    "recorded",
    "run_signature_audit",
    "run_trace_audit",
    "stub_hotpath",
]

_PKG = Path(__file__).resolve().parent.parent  # src/repro_torch
_THIS = Path(__file__).resolve()
_TORCH = Path(torch.__file__).resolve().parent
_SYNC_OPS = {"aten._local_scalar_dense.default", "aten.nonzero.default", "aten.masked_select.default"}
_INDEX_OPS = ("aten.index.Tensor", "aten.index_put.default", "aten.index_put_.default")
_NARROW = ("torch.bfloat16", "torch.float16")


def audit_config() -> LaminarConfig:
    """Tiny geometry with the full feature surface (memory + Airlock) on."""
    return LaminarConfig(
        num_nodes=64,
        zone_size=32,
        probe_capacity=256,
        max_arrivals_per_tick=32,
        horizon_ms=10.0,
        airlock=True,
        memory=MemoryConfig(enabled=True),
    )


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


class OpRecord(NamedTuple):
    name: str  # "aten.mul.Tensor", or "kernel.<entry>" for a stubbed entry
    sig: tuple  # argument descriptors: shapes, dtypes, scalars
    dtypes_in: Tuple[str, ...]
    dtypes_out: Tuple[str, ...]
    sync: bool  # the op reads a device value on the host
    where: Optional[Tuple[str, int]]  # innermost caller in the port, for syncs


def _describe(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v) for v in x)
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        return repr(x)
    if isinstance(x, (torch.dtype, torch.device, torch.layout, torch.memory_format)):
        return str(x)
    return type(x).__name__


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _caller() -> Optional[Tuple[str, int]]:
    """The innermost frame outside torch and this module."""
    for fr in reversed(traceback.extract_stack()):
        p = Path(fr.filename).resolve()
        if p == _THIS or p.is_relative_to(_TORCH) or p.name == "contextlib.py":
            continue
        try:
            return str(p.relative_to(_PKG.parent.parent)), fr.lineno
        except ValueError:
            return str(p), fr.lineno
    return None


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched while active (unless paused)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def note_kernel(self, entry: str, plan) -> None:
        geo = tuple((L.kernel, L.grid, L.block, L.dynamic_smem) for L in plan.launches)
        outs = tuple((o.shape, str(o.dtype)) for o in plan.outputs)
        self.ops.append(OpRecord(f"kernel.{entry}", (geo, outs), (), (), False, None))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name = str(func)
        sync = name in _SYNC_OPS or (
            name in _INDEX_OPS
            and any(t.dtype == torch.bool for t in _tensors(args[1] if len(args) > 1 else ()))
        )
        sig = _describe(list(args)) + tuple(
            (k, _describe(v)) for k, v in sorted(kwargs.items())
        )
        if name == "aten.lift_fresh.default":  # a constant: its value shapes the program
            sig += tuple(args[0].flatten().tolist()) if args[0].numel() <= 64 else ()
        self.ops.append(OpRecord(
            name,
            sig,
            tuple(sorted({str(t.dtype) for t in _tensors((args, kwargs))})),
            tuple(sorted({str(t.dtype) for t in _tensors(out)})),
            sync,
            _caller() if sync else None,
        ))
        return out


@contextlib.contextmanager
def stub_hotpath(recorder: Optional[OpRecorder] = None):
    """Replace the entries' wrappers by their plans' outputs (zeros).

    ``core.hotpath`` looks each wrapper up on its ops module at call time,
    so patching the module attribute reaches every call site."""
    patched = []

    def make(entry: str):
        def stub(*args, **kw):
            plan = ENTRIES[entry].plan(*args, **kw)
            dev = next(_tensors(args)).device
            ctx = recorder.paused() if recorder is not None else contextlib.nullcontext()
            with ctx:
                outs = [torch.zeros(o.shape, dtype=o.dtype, device=dev) for o in plan.outputs]
            if recorder is not None:
                recorder.note_kernel(entry, plan)
            return outs[0] if len(outs) == 1 else tuple(outs)

        return stub

    try:
        for entry, e in ENTRIES.items():
            mod = importlib.import_module(e.wrapper.__module__)
            patched.append((mod, entry, getattr(mod, entry)))
            setattr(mod, entry, make(entry))
        yield
    finally:
        for mod, entry, fn in patched:
            setattr(mod, entry, fn)


def _base_state(cfg: LaminarConfig):
    return engine.LaminarEngine(cfg, device="cpu").init(0)


def recorded(make_body: Callable[[], Callable[[], Any]], stubbed: bool = False):
    """The ops of one call of a body from ``make_body()`` and its result.

    A first body runs unrecorded, as ``core.scan`` runs a warm-up tick
    before it captures: a table the first call in a process fills (the
    histogram edges of ``state._edges_on``) fills there, so the trace does
    not depend on what ran before it. ``make_body`` runs outside both
    calls, so each body starts from state of its own. ``stubbed``: the
    hot-path entries by their plans' outputs, in both calls."""
    with stub_hotpath() if stubbed else contextlib.nullcontext():
        make_body()()
    body = make_body()
    with OpRecorder() as rec, stub_hotpath(rec) if stubbed else contextlib.nullcontext():
        out = body()
    return rec.ops, out


def record_tick(
    cfg: LaminarConfig,
    scenario: Optional[ScenarioConfig] = None,
    base: Any = None,
):
    """Record one tick (t = 0) and the making of its draws (:func:`recorded`).

    Returns ``(ops, s_in, s_out, ts)``. ``base`` is ``(state, lam)`` from
    ``LaminarEngine.init`` (the geometry does not depend on the scenario)."""
    if scenario is not None:
        cfg = dataclasses.replace(cfg, scenario=scenario)
    s, lam = base if base is not None else _base_state(cfg)
    step = engine.make_step(cfg)

    def make_body():
        draws = TorchDraws(cfg, lam, s.zstart.shape[0], seed=0, device="cpu")
        return lambda: step(s, draws.tick(0))

    ops, (s2, ts) = recorded(make_body, stubbed=True)
    return ops, s, s2, ts


def fingerprint(ops: Sequence[OpRecord]) -> str:
    """Digest of the op trace: names, shapes, dtypes and scalar arguments."""
    h = hashlib.sha256()
    for op in ops:
        h.update(repr((op.name, op.sig)).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# LC101 / LC202 / LC203 over recorded ops
# ---------------------------------------------------------------------------


def _leaves(x: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            yield from _leaves(getattr(x, f), f"{prefix}.{f}" if prefix else f)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, x


def audit_ops(
    ops: Sequence[OpRecord], s_in: Any = None, s_out: Any = None, subject: str = "tick"
) -> List[Finding]:
    """Host syncs and dtype hazards in a recorded op trace (and, given both
    states, state legs whose dtype the tick changes)."""
    findings: List[Finding] = []
    seen = set()

    def once(key, finding):
        if key not in seen:
            seen.add(key)
            findings.append(finding)

    for op in ops:
        if op.sync:
            file, line = op.where or (None, None)
            once(("sync", op.name, op.where), Finding(
                rule="LC101",
                message=f"{subject}: `{op.name}` reads a device value on the host (a sync inside the tick)",
                file=file, line=line,
            ))
        if "torch.float64" in op.dtypes_in + op.dtypes_out:
            once(("f64", op.name), Finding(
                rule="LC202",
                message=f"{subject}: float64 tensor at `{op.name}` — host numpy or a Python "
                        "float leaked into the tick",
            ))
        if "torch.float32" in op.dtypes_in and any(d in _NARROW for d in op.dtypes_out):
            once(("narrow", op.name), Finding(
                rule="LC203",
                message=f"{subject}: float32 narrowed to {'/'.join(op.dtypes_out)} at "
                        f"`{op.name}` — accumulator precision loss breaks bit parity",
            ))
    if s_in is not None and s_out is not None:
        before = dict(_leaves(s_in))
        for name, leg in _leaves(s_out):
            old = before.get(name)
            if isinstance(leg, torch.Tensor) and isinstance(old, torch.Tensor) and leg.dtype != old.dtype:
                findings.append(Finding(
                    rule="LC202",
                    message=f"{subject}: state leg {name} changes dtype across the tick "
                            f"({old.dtype} -> {leg.dtype})",
                ))
    return findings


# ---------------------------------------------------------------------------
# LC204: CUDA route (plan outputs) vs CPU route
# ---------------------------------------------------------------------------


def _avals(x: Any) -> List[Tuple[str, Tuple[int, ...], str]]:
    return [(n, tuple(v.shape), str(v.dtype)) for n, v in _leaves(x) if isinstance(v, torch.Tensor)]


def compare_branch_avals(
    name: str, fn_cpu: Callable, fn_cuda: Callable, args: Sequence[Any],
    file: Optional[str] = None,
) -> List[Finding]:
    """LC204 for one dispatch pair: both routes must agree on the shapes
    and dtypes of every output."""
    cuda_route, cpu_route = _avals(fn_cuda(*args)), _avals(fn_cpu(*args))
    if cuda_route == cpu_route:
        return []
    diff = [f"{a} vs {b}" for a, b in zip(cuda_route, cpu_route) if a != b]
    if len(cuda_route) != len(cpu_route):
        diff.append(f"{len(cuda_route)} vs {len(cpu_route)} outputs")
    return [Finding(
        rule="LC204",
        message=f"{name}: CUDA route and CPU route disagree: " + "; ".join(diff[:8]),
        file=file,
    )]


def compare_routes(
    name: str, fn: Callable, args: Sequence[Any], file: Optional[str] = None
) -> List[Finding]:
    """LC204 for one entry: ``fn(*args)`` under the stubs (the plan's
    outputs, as the CUDA route allocates them) against the CPU route."""

    def cuda_route(*a):
        with stub_hotpath():
            return fn(*a)

    return compare_branch_avals(name, fn, cuda_route, args, file)


def _hotpath_cases(cfg: LaminarConfig, s: Any):
    N, A = cfg.num_nodes, cfg.atoms_per_node
    W, P, K = A // 32, cfg.probe_capacity, cfg.candidate_k
    Z, M = s.zmember.shape
    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype)

    return [
        ("bitmap_fit", hotpath.bitmap_fit, (z(N, W, dtype=i32), z(N, dtype=i32), z(N, dtype=b8))),
        ("bitmap_fit_blocked", hotpath.bitmap_fit_blocked,
         (z(Z, M, W, dtype=i32), z(Z, M, dtype=i32), z(Z, M, dtype=b8))),
        ("bitmap_fit_rounds", hotpath.bitmap_fit_rounds, (cfg, s, z(N, dtype=b8))),
        ("bitmap_fit_rounds_blocked", hotpath.bitmap_fit_rounds_blocked,
         (cfg, s, z(N, dtype=b8), *zone_block(s.zmember, s.zmask, 0, 1, N))),
        ("utility_topk", hotpath.utility_topk, (z(P, K), z(P, K), z(P, K), z(P, K, dtype=b8), 1.0)),
        ("utility_topk_address", hotpath.utility_topk_address,
         (cfg, s, TorchDraws(cfg, 1.0, Z, seed=0, device="cpu").tick(0),
          zhaf.build_view(cfg, s))),
        ("zone_aggregate", hotpath.zone_aggregate, (z(Z, M), z(Z, M), z(Z, M))),
        ("zone_aggregate_members", hotpath.zone_aggregate_members,
         (s.rep_S, s.rep_H, s.zmember, s.zmask, s.t, s.zS, s.zH)),
        ("survival_scan", hotpath.survival_scan, (cfg, s)),
        ("node_view", hotpath.node_view, (cfg, s.free)),
        ("survival_scan[kernel OOM]", hotpath.survival_scan,
         (dataclasses.replace(cfg, airlock=False), s)),
    ]


def audit_mode_parity(
    base: Any = None, progress: Optional[Callable[[str], None]] = None
) -> List[Finding]:
    log = progress or (lambda m: None)
    cfg = audit_config()
    s, lam = base if base is not None else _base_state(cfg)
    findings: List[Finding] = []
    for name, fn, args in _hotpath_cases(cfg, s):
        log(f"trace: mode parity [{name}]")
        findings.extend(compare_routes(f"hotpath.{name}", fn, args,
                                       file="src/repro_torch/core/hotpath.py"))
    log("trace: mode parity [whole step]")
    draws = TorchDraws(cfg, lam, s.zstart.shape[0], seed=0, device="cpu")
    d = draws.tick(0)
    findings.extend(compare_routes("engine.make_step", engine.make_step(cfg), (s, d),
                                   file="src/repro_torch/core/engine.py"))
    return findings


# ---------------------------------------------------------------------------
# LC201: cache-key coverage
# ---------------------------------------------------------------------------

# Which preset turns on which ScenarioConfig leaf: a field shapes the tick
# only where its code path runs (mmpp knobs are dead under a stationary
# schedule), so each is audited where it is live.
SCENARIO_FIELD_PLAN: Dict[str, Tuple[str, ...]] = {
    "stationary": ("name", "schedule.kind", "disruption.enabled"),
    "bursty": (
        "schedule.lam_max_factor",
        "schedule.mmpp_dwell_ms",
        "schedule.mmpp_burst_prob",
        "schedule.mmpp_lo_factor",
        "schedule.mmpp_hi_factor",
    ),
    "diurnal": ("schedule.diurnal_period_ms", "schedule.diurnal_amplitude"),
    "flash": (
        "schedule.flash_period_ms",
        "schedule.flash_width_ms",
        "schedule.flash_amplitude",
    ),
    "churn": (
        "disruption.fail_event_prob",
        "disruption.fail_block",
        "disruption.downtime_ms",
        "disruption.drain",
    ),
}

_KIND_CYCLE = {k: KINDS[(i + 1) % len(KINDS)] for i, k in enumerate(KINDS)}


def perturb_value(value: Any, field_name: str) -> Any:
    """A same-type value guaranteed to differ from ``value``."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    if isinstance(value, float):
        return value * 1.5 + 0.25
    if isinstance(value, str):
        if field_name == "kind":
            return _KIND_CYCLE.get(value, KINDS[0])
        return value + "_perturbed"
    raise TypeError(f"no perturbation for {field_name}={value!r}")


def perturb_field(obj: Any, path: str) -> Any:
    """Frozen-dataclass copy of ``obj`` with the dotted-path leaf perturbed."""
    head, _, rest = path.partition(".")
    value = getattr(obj, head)
    new = perturb_field(value, rest) if rest else perturb_value(value, head)
    return dataclasses.replace(obj, **{head: new})


def audit_signature_coverage(
    base: Any,
    fields: Sequence[str],
    trace_fn: Callable[[Any], str],
    signature_fn: Optional[Callable[[Any], Any]] = None,
    subject: str = "ScenarioConfig",
) -> List[Finding]:
    """Perturb each field; flag trace-changing fields the key misses.

    ``trace_fn(obj) -> fingerprint`` defines the recorded computation;
    ``signature_fn`` defaults to ``obj.signature()``. Over-keying is not a
    finding: a too-fine key costs a capture, a too-coarse one replays the
    wrong program."""
    sig = signature_fn or (lambda o: o.signature())
    base_fp, base_sig = trace_fn(base), sig(base)
    findings: List[Finding] = []
    for path in fields:
        pert = perturb_field(base, path)
        if trace_fn(pert) != base_fp and sig(pert) == base_sig:
            findings.append(Finding(
                rule="LC201",
                message=(
                    f"{subject} field `{path}` changes the tick's recorded op trace but "
                    "leaves the cache-key signature unchanged — two configs differing "
                    "only in it would share one captured tick"
                ),
            ))
    return findings


_CONFIG_CLASSES = (
    LaminarConfig,
    WorkloadConfig,
    MemoryConfig,
    BaselineConfig,
    ScenarioConfig,
    ScheduleConfig,
    DisruptionConfig,
)


def check_config_declarations() -> List[Finding]:
    """The static half of LC201: a config's key is its frozen value, so every
    config class is frozen and every field takes part in equality."""
    findings: List[Finding] = []
    for cls in _CONFIG_CLASSES:
        if not cls.__dataclass_params__.frozen:
            findings.append(Finding(
                rule="LC201",
                message=f"{cls.__name__} is not frozen — a config the tick reads as static "
                        "must be immutable and hash by value",
            ))
        for f in dataclasses.fields(cls):
            if not f.compare:
                findings.append(Finding(
                    rule="LC201",
                    message=f"{cls.__name__}.{f.name} is declared compare=False — it is "
                            "left out of the config's value and of every key built on it",
                ))
    return findings


def run_signature_audit(
    base: Any = None, progress: Optional[Callable[[str], None]] = None
) -> List[Finding]:
    """ScenarioConfig field sweep across the activating presets; each
    preset's own tick also goes through :func:`audit_ops`."""
    log = progress or (lambda m: None)
    cfg = audit_config()
    base = base if base is not None else _base_state(cfg)
    findings: List[Finding] = []
    for preset, fields in SCENARIO_FIELD_PLAN.items():
        log(f"trace: signature audit [{preset}] ({len(fields)} fields)")
        ops, s_in, s_out, _ = record_tick(cfg, SCENARIOS[preset], base)
        findings.extend(audit_ops(ops, s_in, s_out, subject=f"tick[{preset}]"))
        findings.extend(audit_signature_coverage(
            SCENARIOS[preset], fields,
            lambda sc: fingerprint(record_tick(cfg, sc, base)[0]),
            subject=f"ScenarioConfig[{preset}]",
        ))
    return findings


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_trace_audit(progress: Optional[Callable[[str], None]] = None) -> List[Finding]:
    log = progress or (lambda m: None)
    cfg = audit_config()
    base = _base_state(cfg)
    findings = check_config_declarations()
    findings.extend(audit_mode_parity(base, progress))
    for name in ("storm",):
        log(f"trace: sync and dtype audit [{name}]")
        ops, s_in, s_out, _ = record_tick(cfg, SCENARIOS[name], base)
        if not any(op.name.startswith("kernel.") for op in ops):
            raise RuntimeError("trace: no hot-path entry reached the stubs")
        findings.extend(audit_ops(ops, s_in, s_out, subject=f"tick[{name}]"))
    findings.extend(run_signature_audit(base, progress))
    return findings
