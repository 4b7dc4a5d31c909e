"""Decode ms a step of the port's LM at full width on the card, as
``chip_smoke.py`` phase 8a times it, for comparing two trees in one call.

    PYTHONPATH=<tree>/src python scripts/torch_decode_ms.py --label parent \
        [--arch qwen3-1.7b] [--batches 1,2,4] [--rounds 3] [--reps 10]
        [--smoke --device cpu]   # a check of the script itself, no timing worth keeping

Imports the port from whatever ``PYTHONPATH`` gives, draws ``--arch``'s
parameters at full width from seed 0 on the card, and times
``lm.decode_step`` from a fresh ``launch.serve.S_MAX``-slot cache (the
serve driver's step): each of ``--rounds`` rounds takes, for each batch
size, the median of ``--reps`` calls after one warm-up call, each call's
wall time on the host clock ending in a synchronize. Then one profiled
step at B = 2 counts its aten ops (nested ones included) and device
kernels. Prints one JSON line: the label, the card's name and power
limit, the medians by batch size and round, and the op counts. Run the
trees in the order parent, change, change, parent in one call, so that
the machine's drift shows.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def host_ms(fn, reps):
    fn()
    _sync()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def op_counts(step, steps=3):
    from torch.profiler import ProfilerActivity, profile

    step()
    _sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        _sync()
    n_dev = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    n_ops = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    return n_ops / steps, n_dev / steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batches", default="1,2,4")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke width")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from repro_torch.configs import get, get_smoke
    from repro_torch.launch.serve import S_MAX
    from repro_torch.models import lm

    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip().splitlines()[0]
            if dev.type == "cuda" else "cpu")
    cfg = (get_smoke if args.smoke else get)(args.arch)
    batches = [int(b) for b in args.batches.split(",")]
    ms = {b: [] for b in batches}
    with torch.inference_mode():
        params = lm.init_params(cfg, 0, dev)

        def step(B):
            tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
            return lambda: lm.decode_step(cfg, params, tok, 10, lm.init_cache(cfg, B, S_MAX, dev))

        for _ in range(args.rounds):
            for B in batches:
                ms[B].append(host_ms(step(B), args.reps))
        aten, kernels = op_counts(step(2))
    print(json.dumps({"label": args.label, "card": card, "arch": args.arch, "cache": S_MAX,
                      "decode_ms": {str(b): v for b, v in ms.items()},
                      "aten_ops_b2": aten, "device_kernels_b2": kernels}))


if __name__ == "__main__":
    main()
