"""Roofline analysis from the dry-run's per-device counts: a port of
``repro.launch.roofline`` with one NVIDIA H100 SXM's peaks.

Terms per (arch x shape) on a mesh (by default the single-pod production
mesh, traced on a fake process group, ``launch.dryrun``):

    compute_s    = FLOPs/device            / PEAK_FLOPS (dense bf16 tensor core)
    memory_s     = bytes accessed/device   / HBM_BW
    collective_s = collective bytes/device / LINK_BW

The reference compiles two reduced-depth variants at full width, a 1-group
body and a doubled one, because XLA's cost analysis counts a scanned body
once; it then extrapolates

    per_group = f(doubled) - f(single)
    total     = f(single) + (n_groups - 1) * per_group

(whisper gets a third variant for its encoder body). The port keeps the
same two variants and the same extrapolation. Its stack unrolls the groups,
so every group's ops are counted: the extrapolated FLOPs equal a direct count
of the full depth exactly. Bytes and collective bytes follow DTensor's
redistribution choices, which can change with the depth of the stacked
leaves; they extrapolate to within a few per cent of a direct count
(``tests/test_torch_dryrun.py``).

``bytes_accessed`` is the dry-run's unfused op-by-op count, so ``memory_s``
is an upper bound of what fused kernels would move; ``compute_s`` counts
matmul FLOPs at the bf16 tensor-core peak whatever the operands' dtype.

Results go to ``results/roofline_torch``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import get, list_archs
from repro_torch.configs.shapes import SHAPES, SUBQUADRATIC_ARCHS
from repro_torch.launch import dryrun
from repro_torch.launch import steps as steps_mod
from repro_torch.parallel.sharding import map_with_path

ROOF = Path(__file__).resolve().parents[3] / "results" / "roofline_torch"

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column (no download: the
# published figures): dense BF16 tensor-core peak 989 TFLOP/s (the sheet's
# 1,979 is with sparsity), HBM3 3.35 TB/s, NVLink 900 GB/s per GPU counted
# in both directions together, so 450 GB/s a direction, the rate one
# device's collective bytes leave it at.
PEAK_FLOPS = 989e12  # bf16 / device
HBM_BW = 3.35e12  # bytes/s / device
LINK_BW = 450e9  # bytes/s / device, NVLink, one direction


def _variant(cfg, mult: int):
    """Full-width config whose whole depth is ``mult`` groups of its pattern."""
    base = cfg.pattern
    kw = dict(pattern=tuple(base) * mult, n_layers=len(base) * mult)
    if cfg.enc_layers > 0:
        kw["enc_layers"] = 1
    return dataclasses.replace(cfg, **kw)


def _step(cfg, shape):
    if shape.kind == "train":
        return steps_mod.make_train_step(cfg)
    if shape.kind == "prefill":
        return steps_mod.make_prefill_step(cfg)
    return steps_mod.make_serve_step(cfg)


def _measure(cfg, shape, mesh):
    """Trace one variant; returns dict(flops, bytes, coll, coll_by_kind)."""
    rec = dryrun.trace_cost(cfg, shape, _step(cfg, shape), mesh)
    coll = rec["collectives"]
    return {
        "flops": float(rec["cost"]["flops"] or 0.0),
        "bytes": float(rec["cost"]["bytes_accessed"] or 0.0),
        "coll": float(coll.get("total_bytes") or 0.0),
        "coll_by_kind": {k: v for k, v in coll.items() if k not in ("count", "total_bytes")},
    }


def _extrapolate(cfg, shape, mesh):
    """Totals via the 1-group / 2-group differencing."""
    groups = cfg.n_layers // len(cfg.pattern)
    f1 = _measure(_variant(cfg, 1), shape, mesh)
    if groups == 1 and cfg.enc_layers <= 1:
        out = {k: f1[k] for k in ("flops", "bytes", "coll")}
        out["coll_by_kind"] = f1["coll_by_kind"]
        return out
    f2 = f1 if groups == 1 else _measure(_variant(cfg, 2), shape, mesh)

    def combine(k):
        body = max(f2[k] - f1[k], 0.0)
        return f1[k] + (groups - 1) * body

    out = {k: combine(k) for k in ("flops", "bytes", "coll")}
    if cfg.enc_layers > 1:  # whisper: separate encoder body
        f3 = _measure(dataclasses.replace(_variant(cfg, 1), enc_layers=2), shape, mesh)
        for k in ("flops", "bytes", "coll"):
            out[k] += (cfg.enc_layers - 1) * max(f3[k] - f1[k], 0.0)
    out["coll_by_kind"] = f2["coll_by_kind"]
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D (train) / 2*N*D (inference), N_active for MoE."""
    leaves = []
    map_with_path(lambda path, leaf: leaves.append((path.split("/"), tuple(leaf.shape))),
                  steps_mod.abstract_params(cfg))
    total = expert = 0
    for keys, shp in leaves:
        n = math.prod(shp)
        if "embed" in keys:  # gather, not matmul
            continue
        total += n
        if cfg.moe is not None and keys[-1] in ("w_gate", "w_up", "w_down") and len(shp) == 4:
            expert += n
    n_active = total - expert
    if cfg.moe is not None and expert:
        n_active += expert * cfg.moe.top_k / cfg.moe.num_experts
    if shape.kind == "train":
        return 6.0 * n_active * (shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return 2.0 * n_active * (shape.global_batch * shape.seq_len)
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def analyze(cfg, shape, mesh, dryrun_rec=None) -> dict:
    """The roofline record of ``cfg`` at ``shape`` on ``mesh`` (a
    ``DeviceMesh``; a fake one traces any size in this process)."""
    chips = math.prod(mesh.shape)
    t0 = time.time()
    ex = _extrapolate(cfg, shape, mesh)
    terms = {
        "compute_s": ex["flops"] / PEAK_FLOPS,
        "memory_s": ex["bytes"] / HBM_BW,
        "collective_s": ex["coll"] / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    mf_dev = mf / chips
    # roofline fraction: useful model work over what the bottleneck term costs
    frac = (mf_dev / PEAK_FLOPS) / max(max(terms.values()), 1e-30)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "status": "ok",
        "chips": chips,
        "flops_per_device": ex["flops"],
        "bytes_per_device": ex["bytes"],
        "coll_bytes_per_device": ex["coll"],
        **terms,
        "dominant": dominant,
        "model_flops_global": mf,
        "useful_flops_ratio": mf_dev / max(ex["flops"], 1.0),
        "roofline_fraction": frac,
        "memory": (dryrun_rec or {}).get("memory"),
        "wall_s": round(time.time() - t0, 1),
    }


def analyze_cell(arch: str, shape_name: str, mesh=None, dryrun_rec=None, overrides=None) -> dict:
    shape = SHAPES[shape_name]
    if shape.subquadratic_only and arch not in SUBQUADRATIC_ARCHS:
        return {"arch": arch, "shape": shape_name, "status": "skip"}
    cfg = get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    with dryrun.production_mesh(False, mesh) as m:
        rec = analyze(cfg, shape, m, dryrun_rec)
    rec["arch"], rec["shape"] = arch, shape_name
    return rec


def suggestion(rec: dict) -> str:
    d = rec.get("dominant")
    if d == "compute_s":
        if rec["useful_flops_ratio"] < 0.5:
            return "compute-bound with low useful ratio: cut remat recompute / attention waste"
        return "compute-bound near model FLOPs: increase per-chip batch or accept"
    if d == "memory_s":
        return "HBM-bound: fuse/bf16-cast intermediates, shrink attention working set, better layouts"
    return "collective-bound: reshard to cut all-gathers, overlap collectives with compute"


_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default=None, help="comma-sep ArchConfig overrides"
                    " (bool flags or key=value, e.g. sharded_xent,remat=none)")
    ap.add_argument("--tag", default=None, help="result-file suffix for variants")
    args = ap.parse_args(argv)

    overrides = {}
    if args.opt:
        for item in args.opt.split(","):
            if "=" in item:
                k, v = item.split("=", 1)
                if v.lower() in ("true", "false"):
                    v = v.lower() == "true"
                elif v in _DTYPES:
                    v = _DTYPES[v]
                overrides[k] = v
            else:
                overrides[item] = True

    ROOF.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    with dryrun.production_mesh(False) as mesh:
        for arch in archs:
            for shape_name in shapes:
                suffix = f"__{args.tag}" if args.tag else ""
                out = ROOF / f"{arch}__{shape_name}{suffix}.json"
                if out.exists() and not args.force:
                    print(f"cached: {out.name}")
                    continue
                dr = dryrun.cell_path(arch, shape_name, False)
                dryrun_rec = json.loads(dr.read_text()) if dr.exists() else None
                try:
                    rec = analyze_cell(arch, shape_name, mesh, dryrun_rec, overrides)
                    if rec["status"] == "ok":
                        rec["suggestion"] = suggestion(rec)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                out.write_text(json.dumps(rec, indent=2))
                if rec["status"] == "ok":
                    print(
                        f"{arch} x {shape_name}: dominant={rec['dominant']} "
                        f"[c={rec['compute_s']:.4f}s m={rec['memory_s']:.4f}s "
                        f"x={rec['collective_s']:.4f}s] "
                        f"useful={rec['useful_flops_ratio']:.2f} "
                        f"roofline={rec['roofline_fraction']:.3f}"
                    )
                else:
                    print(f"{arch} x {shape_name}: {rec['status']}")


if __name__ == "__main__":
    main()
