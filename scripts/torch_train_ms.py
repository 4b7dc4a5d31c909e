"""ms a train step of the port's LM at full width on the card: the compiled
step (``launch.steps.CompiledTrainStep``, a CUDA graph replayed) and the
eager one (``make_train_step``), in one process.

    PYTHONPATH=src python scripts/torch_train_ms.py [--arch qwen3-1.7b] [--layers 28]
        [--batch 2] [--seq 4096] [--steps 6] [--order eager,captured,captured,eager]
        [--label L] [--smoke --device cpu]   # a check of the script itself, no timing worth keeping

Draws ``--arch``'s parameters at full width (``--layers`` of its depth,
default all) from seed 0 on the card and takes ``--steps`` steps on the
batches of ``train.data.make_pipeline`` (seed 0) from that init, once for
each entry of ``--order``, without checkpoints. Each step is timed on the
host clock ending in reading its loss. For each run: the step times, the
ms a step (the median of steps 2-5), tokens/s, the losses, and
``max_memory_allocated`` / ``max_memory_reserved`` from a reset before its
first step (the captured run's first step is the eager warm-up and the
capture). Then one profiled step of each kind (``torch.profiler``): device
busy share and device kernels. Prints one JSON line with the card's name
and power limit, and whether every run's losses are bit-equal.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import time

import numpy as np
import torch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(step, params, state, batches, dev):
    """``step`` over ``batches``: losses, step seconds, final state."""
    losses, secs = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(m["loss"].item())
        secs.append(time.perf_counter() - t0)
    return losses, secs, (params, state)


def profiled(fn, dev) -> dict:
    """One call of ``fn`` (after one more as a warm-up) under the profiler:
    host wall ms, device kernels, device busy share (None: the profiler saw
    no device event, not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    dev_us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"wall_ms": wall * 1e3, "kernels": len(dev_us),
            "busy": sum(dev_us) / 1e6 / wall if dev_us else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--layers", type=int, default=None, help="default: the arch's depth")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--order", default="eager,captured,captured,eager")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke width")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        dev = torch.device("cuda", torch.cuda.current_device())
    from repro_torch.configs import get, get_smoke
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import data, optimizer

    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip().splitlines()[0]
            if dev.type == "cuda" else "cpu")
    cfg = (get_smoke if args.smoke else get)(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=args.steps)
    it = data.make_pipeline(cfg.vocab, args.batch, args.seq, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
               for _ in range(args.steps)]
    tokens = args.batch * args.seq
    runs, profiles = [], {}
    for kind in args.order.split(","):
        params = lm.init_params(cfg, 0, dev)
        state = optimizer.init_opt_state(ocfg, params)
        step = (steps.CompiledTrainStep(cfg, ocfg) if kind == "captured"
                else steps.make_train_step(cfg, ocfg))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, secs, (params, state) = run(step, params, state, batches, dev)
        ms = float(np.median(secs[2:6])) * 1e3
        out = {"kind": kind, "step_s": secs, "ms": ms, "tokens_s": tokens / ms * 1e3,
               "losses": losses}
        if dev.type == "cuda":
            out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
            out["max_memory_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
        if kind not in profiles:
            profiles[kind] = profiled(lambda: step(params, state, batches[0])[2]["loss"].item(),
                                      dev)
        runs.append(out)
        del step, params, state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "card": card, "arch": cfg.name,
                      "layers": cfg.n_layers, "batch": args.batch, "seq": args.seq,
                      "runs": runs, "profiles": profiles,
                      "losses_equal": all(r["losses"] == runs[0]["losses"] for r in runs)}))


if __name__ == "__main__":
    main()
