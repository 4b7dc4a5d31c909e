#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda`` or ``CUDA_HOME``); it
exits non-zero without them, and when ``src/repro_torch`` is not next to it.
It imports neither JAX nor the JAX package. Phases, any failure of which
ends the script with a non-zero exit and no result line:

  1. build the four hot-path kernels from ``src/repro_torch/csrc/`` (one
     ``nvcc`` per source, all at once) and print the seconds;
  2. check each kernel against its plain PyTorch version, run on CPU copies
     of the same inputs, at the shapes of the paper-scale Exp5 geometry and at
     a ragged small shape; time kernel and plain version on the card;
  3. run the engine on the card at the Exp5 geometry (5000 nodes, 65 536
     probe slots, memory dynamics on), Airlock off then on, 2400 ticks each,
     with every launch counter set to 0 just before each run; check the launch
     counts, the task-conservation identity and the host syncs in the ticks;
  4. run a 64-node Exp5 config for 400 ticks on the CPU (plain versions) and
     on the card (kernels) with the same draws, and compare every integer
     metric and the per-tick timeseries;
  5. print the kernel table as JSON, the card's name and power limit, and
     last the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM outside the tensor cores
TICKS = 2400  # 1200 ms at dt = 0.5 ms: the CPU-default Exp5 horizon (paper: 30 s)
PARITY_TICKS = 400
REPLACES = {
    "bitmap_fit": "src/repro/kernels/bitmap_fit/kernel.py:117",
    "utility_topk": "src/repro/kernels/utility_topk/kernel.py:67",
    "zone_aggregate": "src/repro/kernels/zone_aggregate/kernel.py:47",
    "survival_scan": "src/repro/kernels/survival_scan/kernel.py:241",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_cases(N, P, K, Z, M, W, seed):
    """Inputs for each kernel at one geometry, as CPU tensors: (args, kwargs,
    bytes moved, operations)."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy

    words = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    words[: N // 4] = 0xFFFFFFFF
    bitmap = (
        (t(words.view(np.int32)), t(rng.integers(0, 33, N).astype(np.int32)),
         t(rng.uniform(size=N) < 0.2)),
        {},
        N * (4 * W + 4 + 1 + 4),
        N * (40 + 10 * W),
    )
    s = rng.uniform(0, 64, (P, K)).astype(np.float32)
    topk = (
        (t(s), t(rng.uniform(0, 32, (P, K)).astype(np.float32)),
         t(rng.normal(0, 0.5, (P, K)).astype(np.float32)), t(rng.uniform(size=(P, K)) < 0.7), 1.0),
        {},
        P * K * (3 * 4 + 1) + P * 8,
        P * K * 9,
    )
    agg = (
        (t(rng.uniform(0, 64, (Z, M)).astype(np.float32)),
         t(rng.uniform(0, 16, (Z, M)).astype(np.float32)),
         t((rng.uniform(size=(Z, M)) < 0.9).astype(np.float32))),
        {},
        3 * Z * M * 4 + 2 * Z * 4,
        5 * Z * M,
    )
    st = rng.choice([0, 4, 6, 7], size=P, p=[0.3, 0.1, 0.5, 0.1]).astype(np.int32)
    surv = (
        (t(st), t(np.where(st != 0, rng.integers(0, N, P), -1).astype(np.int32)),
         t(rng.uniform(0, 0.1, P).astype(np.float32)),
         t(rng.choice([24.0, 48.0, 96.0, 256.0], P).astype(np.float32)),
         t(rng.integers(0, 3, P).astype(np.int32)), t(rng.uniform(size=P) < 0.1),
         t(rng.integers(0, 300, P).astype(np.int32)),
         t(rng.integers(100, 600, P).astype(np.int32)),
         t(rng.uniform(0.2, 0.8, N).astype(np.float32)), torch.tensor(300, dtype=torch.int32)),
        dict(airlock=True, residual=0.3, watermark=0.9, safe=0.8, t_susp=80, t_surv=240),
        P * (7 * 4 + 1) + N * 4 + 4 + N * 4 + 4 * P,
        P * 40 + N * 10,
    )
    return {"bitmap_fit": bitmap, "utility_topk": topk, "zone_aggregate": agg,
            "survival_scan": surv}


def to_dev(args, dev):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _events_ms(run, reps, rounds):
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out))


def device_ms(fn, reps=20, rounds=5):
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed, so no host launch cost is in the time (median over ``rounds``
    replays, CUDA events). The inputs stay in the 50 MB L2 between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs need
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, reps, rounds)


def call_ms(fn, reps=50, rounds=5):
    """Time of one eager call, host launch cost included (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    return _events_ms(lambda: [fn() for _ in range(reps)], reps, rounds)


def check_kernel(name, wrapper, ref, case, dev):
    args, kw, nbytes, nops = case
    got = [g.cpu() for g in as_tuple(wrapper(*to_dev(args, dev), **kw))]  # waits
    want = as_tuple(ref(*args, **kw))
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name} output {i}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if w.dtype.is_floating_point:
            e = float((g - w).abs().max()) if w.numel() else 0.0
            err = max(err, e)
            # survival_scan's pressure is summed in slot order on both sides:
            # exact; utility_topk (log2f vs the CPU log2) and zone_aggregate
            # (summation order) are held to rtol 1e-5
            tol = 0.0 if name == "survival_scan" else 1e-5
            check(torch.allclose(g, w, rtol=tol, atol=tol),
                  f"{name} output {i}: max abs err {e} beyond rtol {tol}")
        else:
            check(torch.equal(g, w), f"{name} output {i}: "
                  f"{int((g != w).sum())} of {w.numel()} entries differ")
    return err


def phase2(dev, geometry):
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.bitmap_fit import bitmap_fit_ref
    from repro_torch.kernels.survival_scan import survival_scan_ref
    from repro_torch.kernels.utility_topk import utility_topk_ref
    from repro_torch.kernels.zone_aggregate import zone_aggregate_ref

    refs = {"bitmap_fit": bitmap_fit_ref, "utility_topk": utility_topk_ref,
            "zone_aggregate": zone_aggregate_ref, "survival_scan": survival_scan_ref}
    # ragged small shape first: tails that are no multiple of a block
    for name, case in kernel_cases(N=37, P=1029, K=8, Z=3, M=13, W=2, seed=1).items():
        check_kernel(name, WRAPPERS[name], refs[name], case, dev)
    print("phase 2: ragged shapes (N=37, P=1029, Z=3, M=13) equal to the plain versions")
    rows = {}
    for name, case in kernel_cases(**geometry, seed=2).items():
        err = check_kernel(name, WRAPPERS[name], refs[name], case, dev)
        args = to_dev(case[0], dev)
        kw = case[1]
        ms = device_ms(lambda: WRAPPERS[name](*args, **kw))
        plain_ms = device_ms(lambda: refs[name](*args, **kw))
        eager_ms = call_ms(lambda: WRAPPERS[name](*args, **kw))
        bytes_ms = case[2] / HBM_BYTES_PER_S * 1e3
        ops_ms = case[3] / FP32_OPS_PER_S * 1e3
        rows[name] = dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=None, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None,
        )
        print(f"phase 2: {name}: equal to plain version (max abs err {err:.3g}); "
              f"device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{rows[name]['bound_ms']:.5f} ms ({rows[name]['bound_by']}); "
              f"eager call with launch {eager_ms:.4f} ms")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the engine at the Exp5 geometry
# ---------------------------------------------------------------------------


def conservation(out):
    accounted = (out["completed"] + out["oom_kill_f"] + out["oom_kill_l"] + out["reclaimed"]
                 + out["evicted_killed"] + out["resident_end"])
    return out["started"] == accounted and out["arrived"] >= out["started"]


def phase3(dev):
    from repro_torch.core.engine import LaminarEngine, summarize
    from repro_torch.kernels import WRAPPERS
    from repro_torch.profile_tick import exp5_config

    totals = {name: 0 for name in WRAPPERS}
    print(f"phase 3: Exp5 at 5000 nodes / 65536 slots, {TICKS} ticks per run "
          f"(cut from the paper's 30 s horizon to 1.2 s)")
    for airlock in (False, True):
        cfg = exp5_config(airlock, full=True, ticks=TICKS)
        eng = LaminarEngine(cfg, device=dev)
        s, lam = eng.init(0)
        draws = eng.draws(lam, s.zstart.shape[0], seed=0)
        torch.cuda.synchronize()
        for w in WRAPPERS.values():
            w.launches = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                final, ts = eng.simulate(s, draws, TICKS)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in WRAPPERS.items()}
        syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
        out = summarize(cfg, final, ts.cpu().numpy())
        for name in totals:
            totals[name] += launches[name]
        tag = "airlock" if airlock else "kernel-oom"
        print(f"phase 3 [{tag}]: {TICKS / wall:.1f} ticks/s ({wall:.2f} s), "
              f"exec_survival_ratio={out['exec_survival_ratio']:.6f} "
              f"oom_kill_l={out['oom_kill_l']} "
              f"completed_success_ratio={out['completed_success_ratio']:.6f} "
              f"started={out['started']} suspended={out['suspended_cnt']} "
              f"launches={launches} host_syncs_in_ticks={len(syncs)}")
        for w in syncs[:3]:
            print(f"  sync: {w.message} ({w.filename}:{w.lineno})")
        want = {"bitmap_fit": cfg.arb_rounds * TICKS, "utility_topk": TICKS,
                "zone_aggregate": TICKS, "survival_scan": TICKS}
        check(launches == want, f"[{tag}] launch counts {launches} != {want}")
        check(ts.shape == (TICKS, 11), f"[{tag}] timeseries shape {tuple(ts.shape)}")
        for k in ("exec_survival_ratio", "completed_success_ratio", "start_success_ratio",
                  "p50_ms", "p99_ms"):
            check(np.isfinite(out[k]), f"[{tag}] {k} = {out[k]}")
        check(out["started"] > 0 and 0.0 <= out["exec_survival_ratio"] <= 1.0,
              f"[{tag}] degenerate run: started={out['started']}")
        check(conservation(out), f"[{tag}] task conservation broken")
        if airlock:
            check(out["suspended_cnt"] > 0 and out["oom_kill_l"] + out["oom_kill_f"] == 0,
                  f"[{tag}] Airlock did not act as expected")
        else:
            check(out["oom_kill_l"] + out["oom_kill_f"] > 0, f"[{tag}] no kernel-OOM kills")
    return totals


# ---------------------------------------------------------------------------
# phase 4: CPU (plain versions) against CUDA (kernels) on the same draws
# ---------------------------------------------------------------------------


def phase4(dev):
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.engine import LaminarEngine
    from repro_torch.profile_tick import exp5_config

    for airlock in (False, True):
        cfg = exp5_config(airlock, full=False, ticks=PARITY_TICKS)
        outs = []
        for device in ("cpu", dev):
            eng = LaminarEngine(cfg, device=device)
            s, lam = eng.init(0)
            draws = TorchDraws(cfg, lam, s.zstart.shape[0], seed=0, device=device,
                               generator_device="cpu")
            outs.append(eng.run(seed=0, num_ticks=PARITY_TICKS, draws=draws))
        cpu, gpu = outs
        tag = "airlock" if airlock else "kernel-oom"
        first = None
        for f in cpu["timeseries"]:
            d = np.nonzero(cpu["timeseries"][f] != gpu["timeseries"][f])[0]
            if len(d) and (first is None or d[0] < first[0]):
                first = (int(d[0]), f)
        diff = [k for k, v in cpu.items()
                if isinstance(v, int) and v != gpu[k]]
        if not np.array_equal(cpu["lat_hist"], gpu["lat_hist"]):
            diff.append("lat_hist")
        print(f"phase 4 [{tag}]: 64 nodes, {PARITY_TICKS} ticks, started={cpu['started']}: "
              + ("CPU == CUDA on every integer metric and timeseries" if first is None and not diff
                 else f"first divergence at tick {first}, differing metrics {diff}"))
        check(first is None and not diff, f"[{tag}] CPU and CUDA engines diverge")
        check(cpu["started"] > 0, f"[{tag}] degenerate parity run")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.state import init_numpy
    from repro_torch.kernels import _build
    from repro_torch.profile_tick import exp5_config

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    try:
        secs = _build.build()
        print(f"phase 1: built {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())} "
              f"({time.perf_counter() - t0:.1f} s wall, nvcc in parallel)")
        for name in _build.NAMES:
            log = _build.lib_path(name).with_suffix(".log")
            regs = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] if log.exists() else []
            print(f"  {name}: {'; '.join(regs)}")

        cfg = exp5_config(False, full=True, ticks=TICKS)
        geo = init_numpy(cfg, 0)
        Z, M = geo["zmember"].shape
        geometry = dict(N=cfg.num_nodes, P=cfg.probe_capacity, K=cfg.candidate_k,
                        Z=Z, M=M, W=2)
        print(f"phase 2: Exp5 geometry {geometry}")
        rows = phase2(dev, geometry)
        launches = phase3(dev)
        for name, n in launches.items():
            rows[name]["launches"] = n
        phase4(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": list(rows.values())}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi unavailable (rc {smi.returncode})")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
