"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step once, in
one CPU process, and record what one device of the mesh would hold and do.
A port of ``repro.launch.dryrun``.

Where the reference compiles each cell on 512 forced host devices, this
opens a *fake* process group of the mesh's size (``launch.mesh``), builds
the production ``DeviceMesh`` on it, makes the step's inputs under
``FakeTensorMode`` as DTensors placed by the sharding rules (each rank's
shard a fake tensor: shapes, no memory) and calls the step once. A
dispatch mode, :class:`LocalCost`, sees every
op a rank runs on its local shards (DTensor-level ops fall through to
their local ops) and counts, per device:

  * memory — argument, output and temp bytes of the local tensors
    (``temp_bytes``: the peak of the bytes the step allocates and holds at
    once; ``generated_code_bytes`` is ``None``, nothing is compiled);
  * cost — FLOPs of the matmul-like ops (``torch.utils.flop_counter``'s
    formulas), transcendentals (one an output element of exp, log, tanh,
    sin, cos, rsqrt, sqrt, pow, softmax, ...), and ``bytes_accessed``: the
    operands' and results' bytes of every local op that moves data, op by
    op, unfused (NOT XLA's fused count, which is much smaller);
  * collectives — result bytes per kind of the functional collectives
    DTensor issues (all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute), their ``count`` and ``total_bytes``. On a CPU mesh
    DTensor lowers an all-to-all to all-gather + chunk, so the dry-run
    counts those bytes as all-gather.

The step runs eagerly (no ``while`` loop), so every group of the stack is
counted: the numbers need no scan correction.

Results go to ``results/dryrun_torch`` (never the reference's
``results/dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import list_archs
from repro_torch.configs.shapes import SHAPES, SUBQUADRATIC_ARCHS
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.models import regions
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt
from repro_torch.train.optimizer import AdamState

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
_COLLECTIVE_OPS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
                   ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
                   ("permute", "collective-permute"))
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "sigmoid", "sin",
    "cos", "tan", "rsqrt", "sqrt", "pow", "erf", "_softmax", "_log_softmax", "logsumexp",
))
# ops that allocate or describe without reading or writing elements
_NO_DATA = frozenset(("empty", "empty_strided", "empty_like", "detach", "device",
                      "_local_scalar_dense", "lift_fresh", "wait_tensor"))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class LocalCost(TorchDispatchMode):
    """Counts the work of the local ops one rank runs. An op on DTensors is
    passed on (``NotImplemented``) to DTensor's own dispatch, whose local
    ops come back here: only per-device work is counted, never the global
    op (a ``FlopCounterMode`` around DTensor ops counts global FLOPs).

    DTensor's sharding propagation runs each new op once more at its global
    shape on fake tensors, to learn the output's shape; while the mode is
    entered, that propagation (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, a private method) is wrapped so
    its ops are not counted."""

    def __init__(self):
        super().__init__()
        self._paused = 0
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.collectives: Dict[str, int] = {}
        self.collective_count = 0
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def shadow(prop, op_schema):
            self._paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._paused -= 1

        self._orig = orig
        ShardingPropagator._propagate_tensor_meta_non_cached = shadow
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name = func.overloadpacket.__name__.rstrip("_")
        ns = func.namespace
        if "c10d" in ns:
            for key, kind in _COLLECTIVE_OPS:
                if key in name:
                    self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                        _nbytes(t) for t in tree_leaves(out))
                    self.collective_count += 1
                    break
            return out
        if func.overloadpacket in flop_registry:
            self.flops += int(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
        if name in _TRANSCENDENTAL:
            src = args[0] if name.startswith("_") or name == "logsumexp" else out
            self.transcendentals += sum(t.numel() for t in tree_leaves(src)
                                        if isinstance(t, torch.Tensor))
        if not func.is_view and name not in _NO_DATA and ns in ("aten", "prims"):
            self.bytes_accessed += sum(_nbytes(t) for t in tree_leaves((args, kwargs, out)))
            self._track(out)
        return out

    def record(self) -> Dict[str, Any]:
        coll = {k: self.collectives[k] for k in COLLECTIVE_KINDS if k in self.collectives}
        coll["count"] = self.collective_count
        coll["total_bytes"] = sum(v for k, v in coll.items() if k in COLLECTIVE_KINDS)
        return {
            "cost": {"flops": float(self.flops), "bytes_accessed": float(self.bytes_accessed),
                     "transcendentals": float(self.transcendentals)},
            "collectives": coll,
            "temp_bytes": self.peak,
        }


def _dpx(mesh):
    dp = sharding.dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def shardings_for(mesh, shape_kind: str, args, cfg=None):
    """The spec trees matching the step signature (the reference's
    ``in_shardings``)."""
    infer_zero3 = cfg.zero3_inference if cfg is not None else True
    row_par = cfg.row_parallel if cfg is not None else False
    kv_rep = cfg.kv_replicated if cfg is not None else False
    dpx = _dpx(mesh)

    def extra_spec(k):  # pos3 (3, B, S); enc_embeds (B, enc_seq, d)
        return (None, dpx, None) if k == "pos3" else (dpx, None, None)

    def extras_specs(ex):
        return {k: extra_spec(k) for k in ex}

    if shape_kind == "train":
        params_abs, opt_abs, batch_abs = args
        pspecs = sharding.tree_param_specs(mesh, params_abs, row_parallel=row_par,
                                           kv_replicated=kv_rep)
        ospecs = AdamState(step=(), mu=pspecs, nu=pspecs,
                           err=None if opt_abs.err is None else pspecs)
        bspecs = {k: sharding.tokens_spec(mesh) if k in ("tokens", "labels")
                  else extra_spec(k) for k in batch_abs}
        return (pspecs, ospecs, bspecs)

    pspecs = sharding.tree_param_specs(mesh, args[0], train=infer_zero3,
                                       row_parallel=row_par, kv_replicated=kv_rep)
    if shape_kind == "prefill":
        _, _, caches_abs, extras_abs = args
        return (pspecs, sharding.tokens_spec(mesh), sharding.tree_cache_specs(mesh, caches_abs),
                extras_specs(extras_abs))
    _, tok_abs, _, caches_abs, extras_abs = args
    tok_spec = sharding.tokens_spec(mesh) if tok_abs.shape[0] > 1 else (None, None)
    return (pspecs, tok_spec, (), sharding.tree_cache_specs(mesh, caches_abs),
            extras_specs(extras_abs))


def _place(mesh, args, specs):
    """Every tensor of ``args`` as a DTensor of its spec whose shard is a new
    tensor (fake under ``FakeTensorMode``)."""
    if isinstance(args, torch.Tensor):
        return sharding.shard_like(mesh, args, specs)
    if isinstance(args, (tuple, list)) and not hasattr(args, "_fields"):
        return type(args)(_place(mesh, a, s) for a, s in zip(args, specs))
    return sharding.map_specs(lambda x, s: sharding.shard_like(mesh, x, s), args, specs)


def _step_args(shape, args):
    """The decode step's ``index``, a 0-d int32 as the reference's: the
    last slot of a full cache."""
    if shape.kind == "decode":
        return args[:2] + (torch.full((), shape.seq_len - 1, dtype=torch.int32),) + args[3:]
    return args


def trace_cost(cfg, shape, step, mesh) -> Dict[str, Any]:
    """One traced call of ``step`` on ``mesh`` (fake shards): the per-device
    memory, cost and collectives of :class:`LocalCost`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    abstract = steps_mod.abstract_inputs(cfg, shape)
    specs = shardings_for(mesh, shape.kind, abstract, cfg=cfg)
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)  # DTensor warns of every two-dim all-reduce
    opt.lr_table.cache_clear()  # a table made under another mode is not fake here
    try:
        with FakeTensorMode():
            args = _place(mesh, abstract, specs)
            arg_bytes = sum(_nbytes(regions.shard(t)) for t in tree_leaves(args))
            cost = LocalCost()
            with cost:
                out = step(*_step_args(shape, args))
            out_bytes = sum(_nbytes(regions.shard(t)) for t in tree_leaves(out))
    finally:
        log.setLevel(level)
        opt.lr_table.cache_clear()
    rec = cost.record()
    rec["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "temp_bytes": rec.pop("temp_bytes"), "generated_code_bytes": None}
    return rec


@contextlib.contextmanager
def production_mesh(multi_pod: bool, mesh=None):
    """``mesh`` as given, or the production mesh on a fake group of its size
    (destroyed on exit)."""
    if mesh is not None:
        yield mesh
        return
    with fake_process_group(512 if multi_pod else 256):
        yield make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    verbose: bool = True,
    smoke: bool = False,
    mesh=None,
):
    shape = SHAPES[shape_name]
    if shape.subquadratic_only and arch not in SUBQUADRATIC_ARCHS:
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "skip",
            "reason": "long_500k requires sub-quadratic attention (DESIGN.md)",
        }
    t0 = time.time()
    cfg, shp, step, _ = steps_mod.build_cell(arch, shape_name, smoke=smoke)
    with production_mesh(multi_pod, mesh) as m:
        rec = trace_cost(cfg, shp, step, m)
        devices = math.prod(m.shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "devices": int(devices),
        "compile_s": round(time.time() - t0, 1),
        "memory": rec["memory"],
        "cost": rec["cost"],
        "collectives": rec["collectives"],
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {'multi' if multi_pod else 'single'}-pod]")
        print("  memory:", rec["memory"])
        print("  cost:", rec["cost"])
        print("  collectives:", rec["collectives"])
        print(f"  traced in {rec['compile_s']}s for {devices} devices")
    return rec


def cell_path(arch: str, shape_name: str, multi_pod: bool) -> Path:
    pod = "multi" if multi_pod else "single"
    return RESULTS / f"{arch}__{shape_name}__{pod}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    RESULTS.mkdir(parents=True, exist_ok=True)
    pods = []
    if args.single_pod or not args.multi_pod:
        pods.append(False)
    if args.multi_pod or args.all and not args.single_pod:
        pods.append(True)
    pods = sorted(set(pods))

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)

    failures = 0
    for mp in pods:
        for arch in archs:
            for shape_name in shapes:
                out = cell_path(arch, shape_name, mp)
                if out.exists() and not args.force:
                    print(f"cached: {out.name}")
                    continue
                try:
                    rec = run_cell(arch, shape_name, mp)
                except Exception as e:  # record failures; dry-run must go green
                    traceback.print_exc()
                    rec = {
                        "arch": arch, "shape": shape_name, "multi_pod": mp,
                        "status": "error", "error": f"{type(e).__name__}: {e}",
                    }
                    failures += 1
                out.write_text(json.dumps(rec, indent=2))
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
