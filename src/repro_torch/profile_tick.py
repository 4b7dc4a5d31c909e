"""Where the engine tick's time goes on the card, at the paper's Exp5 geometry.

    python -m repro_torch.profile_tick [--airlock] [--sharded]

Runs the engine on CUDA at the Exp5 geometry (``exp5_config(full=True)``),
warms it up for 200 ticks, then reports, per tick of a 20-tick window: the host wall time to enqueue the tick
and to finish it, the number of device kernels, the summed device kernel
time (so the device's busy and idle shares of the wall time), and the ops
that take the most host time and the kernels that take the most device time
(``torch.profiler``). ``--sharded`` runs the tick of the zone-sharded engine
on a one-rank NCCL group instead of the flat tick. It needs a CUDA card and
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

from repro_torch.core import LaminarConfig, MemoryConfig
from repro_torch.core.engine import LaminarEngine, make_step

WARMUP_TICKS = 200  # past the start-up transient: the probe table has filled
WINDOW_TICKS = 20


def exp5_config(airlock: bool, full: bool = True, ticks: int = 2400) -> LaminarConfig:
    """The paper's Exp5 (``benchmarks/bench_exp5_airlock.py``): memory
    dynamics on, two-phase reservation and regeneration off, no hop loss.
    ``full``: the paper-scale geometry of ``benchmarks/common.py``
    ``bench_cfg(full=True)`` (5000 nodes, 65 536 probe slots, 512 arrivals
    per tick) with a horizon of ``ticks``; otherwise the 64-node Exp5 config
    of ``tests/test_hotpath.py`` (which keeps two-phase and regeneration)."""
    if full:
        return LaminarConfig(
            num_nodes=5000, zone_size=256, probe_capacity=1 << 16,
            max_arrivals_per_tick=512, horizon_ms=ticks * 0.5, rho=0.8,
            two_phase=False, regeneration=False, hop_loss=0.0, airlock=airlock,
            memory=MemoryConfig(enabled=True),
        )
    return LaminarConfig(
        num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
        horizon_ms=ticks * 0.5, rho=0.8, airlock=airlock,
        memory=MemoryConfig(enabled=True),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--airlock", action="store_true", help="Airlock on (default: kernel OOM)")
    ap.add_argument("--sharded", action="store_true",
                    help="the zone-sharded engine's tick on a one-rank NCCL group")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tick: CUDA is not available", file=sys.stderr)
        return 2
    if not args.sharded:
        return profile(args.airlock, LaminarEngine)

    import torch.distributed as dist

    from repro_torch.parallel.engine_mesh import ZoneShardedEngine

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            return profile(args.airlock, ZoneShardedEngine)
        finally:
            dist.destroy_process_group()


def profile(airlock: bool, engine_cls) -> int:
    cfg = exp5_config(airlock)
    eng = engine_cls(cfg, device="cuda")
    s, lam = eng.init(0)
    draws = eng.draws(lam, s.zstart.shape[0], seed=0)
    step = make_step(cfg, plane=eng._plane(s))
    t = 0
    for _ in range(WARMUP_TICKS):
        s, _ = step(s, draws.tick(t))
        t += 1
    torch.cuda.synchronize()

    n = WINDOW_TICKS
    t0 = time.perf_counter()
    for _ in range(n):
        s, _ = step(s, draws.tick(t))
        t += 1
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    print(f"profile_tick: {engine_cls.__name__}, {'airlock' if airlock else 'kernel-oom'}, "
          f"{cfg.num_nodes} nodes, {cfg.probe_capacity} slots, after {WARMUP_TICKS} ticks")
    print(f"host: enqueue {t_enq / n * 1e3:.3f} ms/tick, finished {t_all / n * 1e3:.3f} ms/tick "
          f"({n / t_all:.1f} ticks/s)")

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            s, _ = step(s, draws.tick(t))
            t += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    dev_us = defaultdict(float)
    dev_n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[e.name] += e.time_range.elapsed_us()
            dev_n += 1
    busy = sum(dev_us.values()) / 1e6
    if dev_n == 0:
        print("profiler: no device events recorded (device time not measured)")
    else:
        print(f"profiler window: {wall / n * 1e3:.3f} ms/tick wall, {dev_n / n:.0f} device kernels/tick, "
              f"device busy {busy / n * 1e3:.3f} ms/tick = {busy / wall:.1%} of wall "
              f"(idle {1 - busy / wall:.1%})")
        for name, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  device {us / n:9.1f} us/tick  {name[:90]}")
    ka = prof.key_averages()
    cpu_ops = sorted(ka, key=lambda e: -e.self_cpu_time_total)
    n_ops = sum(e.count for e in ka if e.key.startswith("aten::"))
    print(f"host: {n_ops / n:.0f} aten ops/tick (nested ones included)")
    for e in cpu_ops[:12]:
        print(f"  host {e.self_cpu_time_total / n:9.1f} us/tick self, {e.count / n:6.1f} calls/tick  {e.key[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
