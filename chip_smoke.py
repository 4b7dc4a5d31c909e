#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda`` or ``CUDA_HOME``); it
exits non-zero without them, and when ``src/repro_torch`` is not next to it.
It imports neither JAX nor the JAX package. It opens a one-rank process
group (NCCL, with a gloo subgroup for the CPU copies) for the zone-sharded
engine. Phases, any failure of which ends the script with a non-zero exit
and no result line:

  1. build the hot-path kernels from ``src/repro_torch/csrc/`` (one ``nvcc``
     per source, all at once) and print the seconds;
  2. check each kernel entry against its plain PyTorch version, run on CPU
     copies of the same inputs, at a ragged small shape and at the shapes
     every main path gives it: the Exp5 geometry of phases 3 and 6 (flat
     kernels at 5000 nodes / 65 536 slots, the zone-blocked
     ``bitmap_fit_blocked`` at its 20 x 301 block) and Exp7's top cell of
     phase 5 (65 536 nodes / 131 072 slots, blocked at 253 x 307); time
     kernel and plain version on the card at each;
  3. run the flat engine on the card at the Exp5 geometry (5000 nodes,
     65 536 probe slots, memory dynamics on), Airlock off then on, 800
     ticks each; check the launch counts, the task-conservation identity and
     the host syncs;
  4. run 64-node configs on the CPU (plain versions) and on the card
     (kernels) with the same draws and compare every integer metric and the
     per-tick timeseries: Exp5 Airlock off and on, the six scenario presets
     with Airlock on, and storm through the zone-sharded engine;
  5. Exp7's top cell (65 536 nodes, 131 072 slots, 100 ticks): the flat
     engine and the zone-sharded engine with the same draws; ticks/s, the
     traffic model, equal outputs, blocked launches = 3 x ticks;
  6. the storm scenario at Exp6's full geometry (5000 nodes, 65 536 slots,
     memory on) through the zone-sharded engine, Airlock off then on: node
     failures, kills only without Airlock, task conservation;
  7. print the kernel table as JSON, the card's name and power limit, and
     last the result line.

Every launch counter is set to 0 just before each run of phases 3, 5 and 6
and read just after; the table's ``launches`` sums those runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM outside the tensor cores
# phase 3's horizon: 400 ms at dt = 0.5 ms (paper: 30 s). It ran the CPU
# default of bench_exp5_airlock.py, 2400 ticks, until the later phases came:
# cut to keep the whole script near its earlier time
TICKS = 800
PARITY_TICKS = 400
SCENARIO_TICKS = 200  # phase 4's scenario presets
EXP7_NODES = 65536  # bench_exp7_scale.py --full, top cell
EXP7_TICKS = 100  # bench_exp7_scale.py NUM_TICKS
STORM_TICKS = 2400
REPLACES = {
    "bitmap_fit": "src/repro/kernels/bitmap_fit/kernel.py:117",
    "bitmap_fit_blocked": "src/repro/kernels/bitmap_fit/ops.py:40",
    "utility_topk": "src/repro/kernels/utility_topk/kernel.py:67",
    "zone_aggregate": "src/repro/kernels/zone_aggregate/kernel.py:47",
    "survival_scan": "src/repro/kernels/survival_scan/kernel.py:241",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["bitmap_fit_blocked"] = "src/repro_torch/csrc/bitmap_fit.cu"  # same kernel


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


def blocked_case(member, mask, W, seed):
    """bitmap_fit_blocked inputs on a zone geometry ((Z, M) members and
    validity), padding slots zeroed, as CPU tensors."""
    rng = np.random.default_rng(seed)
    Z, M = member.shape
    N = int(member.max()) + 1
    words = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    words[: N // 4] = 0xFFFFFFFF
    mass = rng.integers(0, 33, N).astype(np.int32)
    contig = rng.uniform(size=N) < 0.2
    valid = mask > 0
    t = torch.from_numpy
    args = (t(np.where(valid[..., None], words[member], 0).astype(np.uint32).view(np.int32)),
            t(np.where(valid, mass[member], 0).astype(np.int32)), t(valid & contig[member]))
    R = Z * M  # the kernel reads every slot, padding included
    return args, {}, R * (4 * W + 4 + 1 + 4), R * (40 + 10 * W)


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


def phase2(dev, geometries):
    """Each kernel entry against its plain version at a ragged shape, then at
    every main-path geometry (``geometries``: label -> (kernel_cases kwargs,
    (zone members, zone mask))). The table's row of a kernel is timed at the
    first geometry, the one of the most launches (phases 3 and 6)."""
    from repro_torch.core.state import densify_zones
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.bitmap_fit import bitmap_fit_blocked_ref, bitmap_fit_ref
    from repro_torch.kernels.survival_scan import survival_scan_ref
    from repro_torch.kernels.utility_topk import utility_topk_ref
    from repro_torch.kernels.zone_aggregate import zone_aggregate_ref

    refs = {"bitmap_fit": bitmap_fit_ref, "bitmap_fit_blocked": bitmap_fit_blocked_ref,
            "utility_topk": utility_topk_ref, "zone_aggregate": zone_aggregate_ref,
            "survival_scan": survival_scan_ref}
    # ragged small shape first: tails that are no multiple of a block
    ragged = kernel_cases(N=37, P=1029, K=8, Z=3, M=13, W=2, seed=1)
    member, mask = densify_zones(np.array([0, 13, 20], np.int32), np.array([13, 7, 10], np.int32))
    ragged["bitmap_fit_blocked"] = blocked_case(member, mask, W=2, seed=1)
    for name, case in ragged.items():
        check_kernel(name, WRAPPERS[name], refs[name], case, dev)
    print("phase 2: ragged shapes (N=37, P=1029, Z=3, M=13; blocked Z=3, M=13 with "
          "zeroed padding slots) equal to the plain versions")
    rows = {}
    for seed, (label, (geometry, zones)) in enumerate(geometries.items(), start=2):
        cases = kernel_cases(**geometry, seed=seed)
        cases["bitmap_fit_blocked"] = blocked_case(*zones, W=geometry["W"], seed=seed)
        print(f"phase 2 [{label}]: {geometry}, blocked (Z, M) = {tuple(zones[0].shape)}")
        for name, case in cases.items():
            err = check_kernel(name, WRAPPERS[name], refs[name], case, dev)
            args = to_dev(case[0], dev)
            kw = case[1]
            ms = device_ms(lambda: WRAPPERS[name](*args, **kw))
            plain_ms = device_ms(lambda: refs[name](*args, **kw))
            eager_ms = call_ms(lambda: WRAPPERS[name](*args, **kw))
            bytes_ms = case[2] / HBM_BYTES_PER_S * 1e3
            ops_ms = case[3] / FP32_OPS_PER_S * 1e3
            row = dict(
                name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=0, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None,
            )
            rows.setdefault(name, row)
            print(f"phase 2 [{label}]: {name}: equal to plain version (max abs err {err:.3g}); "
                  f"device time: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
                  f"{row['bound_ms']:.7f} ms ({row['bound_by']}); "
                  f"eager call with launch {eager_ms:.6f} ms")
    return rows


# ---------------------------------------------------------------------------
# the main paths (phases 3, 5, 6): one run with every launch counter at 0
# ---------------------------------------------------------------------------


def conservation(out):
    accounted = (out["completed"] + out["oom_kill_f"] + out["oom_kill_l"] + out["reclaimed"]
                 + out["evicted_killed"] + out["resident_end"])
    return out["started"] == accounted and out["arrived"] >= out["started"]


def drive(eng, s, draws, ticks):
    """One main-path run: counters set to 0 just before, read just after.
    Returns (summary, launches, host syncs inside the ticks, ticks/s)."""
    from repro_torch.core.engine import summarize
    from repro_torch.kernels import WRAPPERS

    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            final, ts = eng.simulate(s, draws, ticks)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    for w in syncs[:3]:
        print(f"  sync: {w.message} ({w.filename}:{w.lineno})")
    check(ts.shape == (ticks, 11), f"timeseries shape {tuple(ts.shape)}")
    out = summarize(eng.cfg, final, ts.cpu().numpy())
    return out, launches, len(syncs), ticks / wall


def want_launches(cfg, ticks, sharded):
    fit = cfg.arb_rounds * ticks
    return {"bitmap_fit": 0 if sharded else fit, "bitmap_fit_blocked": fit if sharded else 0,
            "utility_topk": ticks, "zone_aggregate": ticks,
            "survival_scan": ticks if cfg.memory.enabled else 0}


def check_run(tag, out, launches, want):
    check(launches == want, f"[{tag}] launch counts {launches} != {want}")
    for k in ("exec_survival_ratio", "completed_success_ratio", "start_success_ratio",
              "p50_ms", "p99_ms"):
        check(np.isfinite(out[k]), f"[{tag}] {k} = {out[k]}")
    check(out["started"] > 0 and 0.0 <= out["exec_survival_ratio"] <= 1.0,
          f"[{tag}] degenerate run: started={out['started']}")
    check(conservation(out), f"[{tag}] task conservation broken")


def add(totals, launches):
    for name, n in launches.items():
        totals[name] += n


# ---------------------------------------------------------------------------
# phase 3: the flat engine at the Exp5 geometry
# ---------------------------------------------------------------------------


def phase3(dev, totals):
    from repro_torch.core.engine import LaminarEngine
    from repro_torch.profile_tick import exp5_config

    print(f"phase 3: Exp5 at 5000 nodes / 65536 slots, {TICKS} ticks per run (cut from the "
          f"paper's 30 s horizon to {TICKS * 0.5 / 1e3:g} s; 2400 ticks until the zone-sharded "
          f"phases came)")
    for airlock in (False, True):
        cfg = exp5_config(airlock, full=True, ticks=TICKS)
        eng = LaminarEngine(cfg, device=dev)
        s, lam = eng.init(0)
        out, launches, syncs, tps = drive(eng, s, eng.draws(lam, s.zstart.shape[0], 0), TICKS)
        add(totals, launches)
        tag = "airlock" if airlock else "kernel-oom"
        print(f"phase 3 [{tag}]: {tps:.1f} ticks/s, "
              f"exec_survival_ratio={out['exec_survival_ratio']:.6f} "
              f"oom_kill_l={out['oom_kill_l']} "
              f"completed_success_ratio={out['completed_success_ratio']:.6f} "
              f"started={out['started']} suspended={out['suspended_cnt']} "
              f"launches={launches} host_syncs_in_ticks={syncs}")
        check_run(tag, out, launches, want_launches(cfg, TICKS, sharded=False))
        if airlock:
            check(out["suspended_cnt"] > 0 and out["oom_kill_l"] + out["oom_kill_f"] == 0,
                  f"[{tag}] Airlock did not act as expected")
        else:
            check(out["oom_kill_l"] + out["oom_kill_f"] > 0, f"[{tag}] no kernel-OOM kills")


# ---------------------------------------------------------------------------
# phase 4: CPU (plain versions) against CUDA (kernels) on the same draws
# ---------------------------------------------------------------------------


def cpu_vs_cuda(tag, cfg, ticks, engines):
    """Run the (device, engine) pairs, CPU then CUDA, with one CPU
    generator's draws and require every integer metric and the timeseries
    equal."""
    from repro_torch.core.draws import TorchDraws

    outs = []
    for device, eng in engines:
        s, lam = eng.init(0)
        draws = TorchDraws(cfg, lam, s.zstart.shape[0], seed=0, device=device,
                           generator_device="cpu")
        outs.append(eng.run(seed=0, num_ticks=ticks, draws=draws))
    cpu, gpu = outs
    first = None
    for f in cpu["timeseries"]:
        d = np.nonzero(cpu["timeseries"][f] != gpu["timeseries"][f])[0]
        if len(d) and (first is None or d[0] < first[0]):
            first = (int(d[0]), f)
    diff = [k for k, v in cpu.items() if isinstance(v, int) and v != gpu[k]]
    if not np.array_equal(cpu["lat_hist"], gpu["lat_hist"]):
        diff.append("lat_hist")
    print(f"phase 4 [{tag}]: {cfg.num_nodes} nodes, {ticks} ticks, started={cpu['started']}, "
          f"node_failures={cpu['node_failures']}: "
          + ("CPU == CUDA on every integer metric and timeseries" if first is None and not diff
             else f"first divergence at tick {first}, differing metrics {diff}"))
    check(first is None and not diff, f"[{tag}] CPU and CUDA engines diverge")
    check(cpu["started"] > 0, f"[{tag}] degenerate parity run")
    return cpu


def phase4(dev, gloo):
    from repro_torch.core.engine import LaminarEngine
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine
    from repro_torch.profile_tick import exp5_config
    from repro_torch.workloads import SCENARIOS

    for airlock in (False, True):
        cfg = exp5_config(airlock, full=False, ticks=PARITY_TICKS)
        cpu_vs_cuda("airlock" if airlock else "kernel-oom", cfg, PARITY_TICKS,
                    (("cpu", LaminarEngine(cfg, device="cpu")), (dev, LaminarEngine(cfg, device=dev))))
    for name, scenario in SCENARIOS.items():
        cfg = dataclasses.replace(exp5_config(True, full=False), scenario=scenario)
        out = cpu_vs_cuda(f"{name}, airlock", cfg, SCENARIO_TICKS,
                          (("cpu", LaminarEngine(cfg, device="cpu")),
                           (dev, LaminarEngine(cfg, device=dev))))
        if scenario.disruption.enabled:
            check(out["node_failures"] > 0, f"[{name}] no node failures in the parity run")
    cfg = dataclasses.replace(exp5_config(True, full=False), scenario=SCENARIOS["storm"])
    cpu_vs_cuda("storm, zone-sharded", cfg, SCENARIO_TICKS,
                (("cpu", ZoneShardedEngine(cfg, num_devices=1, device="cpu", group=gloo)),
                 (dev, ZoneShardedEngine(cfg, num_devices=1, device=dev))))


# ---------------------------------------------------------------------------
# phase 5: Exp7's top cell, flat and zone-sharded
# ---------------------------------------------------------------------------


def exp7_config(num_nodes=EXP7_NODES):
    """``benchmarks/common.py`` ``bench_cfg(num_nodes=...)``, the config of
    each cell of ``benchmarks/bench_exp7_scale.py`` (stationary, memory off)."""
    from repro_torch.core import LaminarConfig

    cap = 1 << max(13, (num_nodes * 8 - 1).bit_length())
    return LaminarConfig(
        num_nodes=num_nodes, zone_size=min(256, max(32, num_nodes // 8)),
        probe_capacity=min(cap, 1 << 17), max_arrivals_per_tick=512, horizon_ms=800.0,
        rho=0.8,
    )


def phase5(dev, totals):
    from repro_torch.core.engine import LaminarEngine
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine

    cfg = exp7_config()
    flat = LaminarEngine(cfg, device=dev)
    s, lam = flat.init(0)
    Z, M = s.zmember.shape
    print(f"phase 5: Exp7 top cell: {cfg.num_nodes} nodes, {Z} zones (M = {M}), "
          f"{cfg.probe_capacity} slots, {cfg.max_arrivals_per_tick} arrivals/tick, "
          f"{EXP7_TICKS} ticks, one card")
    mesh = ZoneShardedEngine(cfg, num_devices=1, device=dev)
    outs = {}
    for tag, eng in (("flat", flat), ("zone-sharded", mesh)):
        out, launches, syncs, tps = drive(eng, s, eng.draws(lam, Z, 0), EXP7_TICKS)
        add(totals, launches)
        outs[tag] = out
        print(f"phase 5 [{tag}]: {tps:.1f} ticks/s, arrived={out['arrived']} "
              f"started={out['started']} completed={out['completed']} "
              f"start_success_ratio={out['start_success_ratio']:.6f} "
              f"launches={launches} host_syncs_in_ticks={syncs}")
        check_run(tag, out, launches, want_launches(cfg, EXP7_TICKS, tag != "flat"))
    print(f"phase 5: traffic model (bytes per tick, modelled) at 1 rank: {mesh.traffic(0)}")
    from repro_torch.parallel.engine_mesh import traffic_model
    print(f"phase 5: traffic model at 4 ranks: {traffic_model(cfg, Z, 4, max_zone=M)}")
    a, b = outs["flat"], outs["zone-sharded"]
    diff = [k for k, v in a.items() if isinstance(v, int) and v != b[k]]
    diff += [f for f in a["timeseries"] if not np.array_equal(a["timeseries"][f], b["timeseries"][f])]
    if not np.array_equal(a["lat_hist"], b["lat_hist"]):
        diff.append("lat_hist")
    print("phase 5: flat == zone-sharded on every integer metric and timeseries" if not diff
          else f"phase 5: flat and zone-sharded differ in {diff}")
    check(not diff, "flat and zone-sharded Exp7 runs differ")


# ---------------------------------------------------------------------------
# phase 6: storm at Exp6's full geometry through the zone-sharded engine
# ---------------------------------------------------------------------------


def phase6(dev, totals):
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine
    from repro_torch.profile_tick import exp5_config
    from repro_torch.workloads import SCENARIOS

    print(f"phase 6: storm at 5000 nodes / 65536 slots, memory on, {STORM_TICKS} ticks per "
          f"run, zone-sharded engine on one card")
    for airlock in (False, True):
        cfg = dataclasses.replace(exp5_config(airlock, full=True, ticks=STORM_TICKS),
                                  scenario=SCENARIOS["storm"])
        eng = ZoneShardedEngine(cfg, num_devices=1, device=dev)
        s, lam = eng.init(0)
        out, launches, syncs, tps = drive(eng, s, eng.draws(lam, s.zstart.shape[0], 0),
                                          STORM_TICKS)
        add(totals, launches)
        tag = "storm, airlock" if airlock else "storm, kernel-oom"
        print(f"phase 6 [{tag}]: {tps:.1f} ticks/s, node_failures={out['node_failures']} "
              f"node_recoveries={out['node_recoveries']} evicted={out['evicted']} "
              f"evicted_killed={out['evicted_killed']} "
              f"exec_survival_ratio={out['exec_survival_ratio']:.6f} "
              f"completed_success_ratio={out['completed_success_ratio']:.6f} "
              f"started={out['started']} launches={launches} host_syncs_in_ticks={syncs}")
        check_run(tag, out, launches, want_launches(cfg, STORM_TICKS, sharded=True))
        check(out["node_failures"] > 0, f"[{tag}] no node failures")
        if airlock:
            check(out["evicted_killed"] == 0, f"[{tag}] Airlock run killed evicted residents")
        else:
            check(out["evicted_killed"] > 0, f"[{tag}] no disruption kills without Airlock")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.core.state import init_numpy
    from repro_torch.kernels import WRAPPERS, _build
    from repro_torch.profile_tick import exp5_config

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # one rank: NCCL for the card's tensors, a gloo subgroup for CPU copies
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            secs = _build.build()
            print(f"phase 1: built {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())} "
                  f"({time.perf_counter() - t0:.1f} s wall, nvcc in parallel)")
            for name in _build.NAMES:
                log = _build.lib_path(name).with_suffix(".log")
                regs = ([ln.strip() for ln in log.read_text().splitlines() if "registers" in ln]
                        if log.exists() else [])
                print(f"  {name}: {'; '.join(regs)}")

            geometries = {}
            for label, cfg in (("Exp5", exp5_config(False, full=True, ticks=TICKS)),
                               ("Exp7", exp7_config())):
                geo = init_numpy(cfg, 0)
                Z, M = geo["zmember"].shape
                geometries[label] = (
                    dict(N=cfg.num_nodes, P=cfg.probe_capacity, K=cfg.candidate_k, Z=Z, M=M,
                         W=cfg.atoms_per_node // 32),
                    (geo["zmember"], geo["zmask"]),
                )
            rows = phase2(dev, geometries)
            totals = {name: 0 for name in WRAPPERS}
            gloo = dist.new_group(ranks=[0], backend="gloo")
            for k, run in ((3, lambda: phase3(dev, totals)), (4, lambda: phase4(dev, gloo)),
                           (5, lambda: phase5(dev, totals)), (6, lambda: phase6(dev, totals))):
                t1 = time.perf_counter()
                run()
                print(f"phase {k}: {time.perf_counter() - t1:.1f} s wall")
            for name, n in totals.items():
                rows[name]["launches"] = n
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        finally:
            dist.destroy_process_group()

    print(f"total wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi unavailable (rc {smi.returncode})")
    # one card driven: the script's process group has one rank
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
