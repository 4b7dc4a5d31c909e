"""Where the engine tick's time goes on the card, at the paper's Exp5 geometry.

    python -m repro_torch.profile_tick [--airlock] [--sharded | --batch B]

Runs the engine on CUDA at the Exp5 geometry (``exp5_config(full=True)``),
warms it up for 200 ticks, then reports, per tick of a 20-tick window: the host wall time to enqueue the tick
and to finish it, the number of device kernels, the summed device kernel
time (so the device's busy and idle shares of the wall time), each
hand-written kernel's device time and launches, and the ops that take the
most host time and the kernels that take the most device time
(``torch.profiler``). It then records what the tick gives its rounds
(``bitmap_fit_rounds``, or on the sharded tick ``bitmap_fit_rounds_blocked``)
over 20 more ticks (:func:`rounds_traffic`: queued slots, winners, and the
free runs of each node whose winner reaches the allocation). ``--sharded``
runs the tick of the zone-sharded engine on a one-rank NCCL group instead
of the flat tick, and also counts its ``all_gather`` calls a tick.
``--batch B`` runs B seeds (0 to B - 1) in lockstep instead, the flat tick
under ``torch.func.vmap`` (``LaminarEngine.simulate_batch``): every number
is then a batched tick's (B seed-ticks), each hand-written kernel launches
once for all seeds, and the rounds traffic is a seed's. It needs a CUDA card
and exits non-zero without one.

Beside that eager tick (``make_step`` driven by hand), every run also
profiles the replayed tick, the one ``simulate`` and ``simulate_batch`` run
(``core.scan``: captured once as a CUDA graph, the sharded tick's NCCL
collectives inside it): after the same 200 ticks through ``simulate``, 20
replays of its graph, with the same numbers, and the graph's nodes
(:func:`replayed_window`; NCCL's kernel nodes apart).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from collections import Counter, defaultdict
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.core import LaminarConfig, MemoryConfig
from repro_torch.core.draws import BatchDraws
from repro_torch.core.engine import LaminarEngine, make_step
from repro_torch.kernels import ENTRIES, HAND_WRITTEN

WARMUP_TICKS = 200  # past the start-up transient: the probe table has filled
WINDOW_TICKS = 20
EXP7_NODES = 65536  # bench_exp7_scale.py --full, top cell
EXP7_TICKS = 100  # bench_exp7_scale.py NUM_TICKS


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


def exp7_config(num_nodes: int = EXP7_NODES) -> LaminarConfig:
    """``benchmarks/common.py`` ``bench_cfg(num_nodes=...)``, the config of
    each cell of ``benchmarks/bench_exp7_scale.py`` (stationary, memory off)."""
    cap = 1 << max(13, (num_nodes * 8 - 1).bit_length())
    return LaminarConfig(
        num_nodes=num_nodes, zone_size=min(256, max(32, num_nodes // 8)),
        probe_capacity=min(cap, 1 << 17), max_arrivals_per_tick=512, horizon_ms=800.0,
        rho=0.8,
    )


@contextmanager
def recording(*entries: str):
    """Record every call of the named kernel entries (``kernels.ENTRIES``)
    made while the block runs, into the dict it yields: entry -> a list of
    ``(args, kw, outputs)``, ``args`` copies of the tensors the call was
    given. The wrapper is replaced on its module, where ``core.hotpath``
    looks it up at each call, and restored after."""
    import importlib

    calls = {e: [] for e in entries}
    patched = []

    def recorder(mod, entry, real):
        def record(*args, **kw):
            kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            # the wrapper counts its launches on itself, by its module name
            setattr(mod, entry, real)
            try:
                out = real(*args, **kw)
            finally:
                setattr(mod, entry, record)
            calls[entry].append((kept, kw, out))
            return out

        return record

    try:
        for e in entries:
            mod = importlib.import_module(ENTRIES[e].wrapper.__module__)
            real = getattr(mod, e)
            setattr(mod, e, recorder(mod, e, real))
            patched.append((mod, e, real))
        yield calls
    finally:
        for mod, e, real in patched:
            setattr(mod, e, real)


def tick_calls(cfg: LaminarConfig, warmup: int, ticks: int, entries, device="cuda",
               seed: int = 0, sharded: bool = False) -> dict:
    """The calls of the named kernel entries (:func:`recording`) in the flat
    engine's ticks ``warmup`` to ``warmup + ticks - 1`` of a run from
    ``seed``; ``sharded``: the zone-sharded engine's, on the initialized
    process group."""
    if sharded:
        from repro_torch.parallel.engine_mesh import ZoneShardedEngine

        eng = ZoneShardedEngine(cfg, device=device)
    else:
        eng = LaminarEngine(cfg, device=device)
    s, lam = eng.init(seed)
    draws = eng.draws(lam, s.zstart.shape[0], seed=seed)
    step = make_step(cfg, plane=eng._plane(s))
    for t in range(warmup):
        s, _ = step(s, draws.tick(t))
    with recording(*entries) as calls:
        for t in range(warmup, warmup + ticks):
            s, _ = step(s, draws.tick(t))
    return calls


def batch_ticker(cfg: LaminarConfig, seeds, device="cuda"):
    """``advance(n)``: the next ``n`` lockstep ticks of ``seeds`` (each its
    own generator; geometry from ``seeds[0]``), the flat tick under
    ``torch.func.vmap`` as ``LaminarEngine.simulate_batch`` runs it."""
    eng = LaminarEngine(cfg, device=device)
    sb, lam = eng.init_batch(seeds)
    draws = BatchDraws([eng.draws(lam, sb.zstart.shape[1], sd) for sd in seeds])
    step = make_step(cfg)
    state = {"s": sb, "t": 0}

    def advance(n: int):
        for _ in range(n):
            d = draws.tick(state["t"])
            state["s"], _ = torch.func.vmap(step, in_dims=(0, BatchDraws.in_dims(d)))(
                state["s"], d)
            state["t"] += 1

    return advance


def batch_tick_calls(cfg: LaminarConfig, seeds, warmup: int, ticks: int, entries,
                     device="cuda") -> dict:
    """The calls of the named kernel entries (:func:`recording`, each call
    with the seed axis) in lockstep ticks ``warmup`` to ``warmup + ticks - 1``
    of ``seeds``."""
    advance = batch_ticker(cfg, seeds, device)
    advance(warmup)
    with recording(*entries) as calls:
        advance(ticks)
    return calls


def per_seed_calls(calls) -> list:
    """Recorded calls with a seed axis as the calls of each seed."""
    return [(tuple(a[i] if isinstance(a, torch.Tensor) else a for a in args), kw,
             tuple(o[i] for o in outs))
            for args, kw, outs in calls for i in range(args[0].shape[0])]


def tick_rounds(cfg: LaminarConfig, warmup: int, ticks: int, device="cuda", seed: int = 0):
    """The ``bitmap_fit_rounds`` calls of the flat engine's ticks ``warmup``
    to ``warmup + ticks - 1`` of a run from ``seed``."""
    return tick_calls(cfg, warmup, ticks, ("bitmap_fit_rounds",), device, seed)[
        "bitmap_fit_rounds"]


def rounds_traffic(calls) -> dict:
    """What the recorded ``bitmap_fit_rounds`` (or ``bitmap_fit_rounds_blocked``:
    then on the rank's block, its slots as the nodes and the queued slots
    those of its nodes) calls were given, a call on average: probe slots,
    queued slots (and those on unthrottled nodes), winners (by round) and
    admissions; and the free runs, on the words of that round, of each node
    whose winner passes the fit test and so reaches the allocation (the
    kernel walks them): a count of such nodes by free runs, for contiguous
    and for dispersed demands."""
    from repro_torch.core.bitmap import unpack_bits
    from repro_torch.core.state import QUEUED
    from repro_torch.kernels.bitmap_fit import bitmap_fit_ref
    from repro_torch.kernels.bitmap_fit.ref import block_view

    n = len(calls)
    sums = Counter()
    runs = {"contiguous": Counter(), "dispersed": Counter()}
    for args, kw, outs in calls:
        winner, feas, alloc = outs[:3]
        if len(args) == 10:  # a zone block: its slots take the place of the nodes
            st, node, words, throttled = block_view(args[0], args[1], *args[5:])
            mass, contig = args[3], args[4]
            R = winner.shape[0]
            winner, feas = winner.reshape(R, -1), feas.reshape(R, -1)
            alloc = alloc.reshape(R, -1, alloc.shape[-1])
        else:
            st, node, _, mass, contig, words, throttled = args
        N = words.shape[0]
        queued = st == QUEUED
        sums["slots"] += st.shape[0]
        sums["queued"] += int(queued.sum())
        sums["queued_open"] += int((queued & ~throttled[node.clamp(0, N - 1)]).sum())
        for r in range(kw["rounds"]):
            live = winner[r] >= 0
            ws = winner[r].clamp(min=0)
            reach = live & (bitmap_fit_ref(words, mass[ws], contig[ws]) != 0)
            bits = unpack_bits(words, kw["atoms"])
            starts = bits.clone()
            starts[:, 1:] &= ~bits[:, :-1]
            nruns = starts.sum(1)
            sums[f"winners_round{r}"] += int(live.sum())
            sums["admitted"] += int(feas[r].sum())
            sums["reach_alloc"] += int(reach.sum())
            for kind, sel in (("contiguous", reach & contig[ws]), ("dispersed", reach & ~contig[ws])):
                vals, cnt = np.unique(nruns[sel].cpu().numpy(), return_counts=True)
                runs[kind].update(dict(zip(vals.tolist(), cnt.tolist())))
            words = words & ~alloc[r]
    out = {k: v / n for k, v in sums.items()}
    out["winners"] = sum(v for k, v in out.items() if k.startswith("winners_round"))
    out["queued_share"] = sums["queued"] / sums["slots"]
    out["free_runs"] = {kind: dict(sorted(c.items())) for kind, c in runs.items()}
    out["calls"] = n
    return out


def print_traffic(label: str, tr: dict) -> None:
    print(f"rounds traffic [{label}], a tick over {tr['calls']} ticks: "
          f"{tr['queued']:.1f} of {tr['slots']:.0f} slots queued "
          f"({tr['queued_share']:.4%}; {tr['queued_open']:.1f} on unthrottled nodes); "
          f"winners {tr['winners']:.1f} ("
          + ", ".join(f"round {k[-1]} {v:.1f}" for k, v in tr.items()
                      if k.startswith("winners_round"))
          + f"), admitted {tr['admitted']:.1f}, reaching the allocation "
          f"{tr['reach_alloc']:.1f}; those nodes by free runs, over all ticks: "
          f"{tr['free_runs']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--airlock", action="store_true", help="Airlock on (default: kernel OOM)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--sharded", action="store_true",
                      help="the zone-sharded engine's tick on a one-rank NCCL group")
    mode.add_argument("--batch", type=int, default=0, metavar="B",
                      help="B seeds in lockstep (the batched tick)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tick: CUDA is not available", file=sys.stderr)
        return 2
    if args.batch:
        return profile_batch(args.airlock, args.batch)
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
    with counting_gathers() as gathers:
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
          f"({n / t_all:.1f} ticks/s); {len(gathers) / n:.1f} all_gather calls/tick")

    def advance(k):
        nonlocal s, t
        for _ in range(k):
            s, _ = step(s, draws.tick(t))
            t += 1

    print_window(window(advance, n))
    s0, _ = eng.init(0)
    print_replayed(replayed_window(eng, s0, eng.draws(lam, s0.zstart.shape[0], seed=0),
                                   lockstep=False))
    entry = "bitmap_fit_rounds" if engine_cls is LaminarEngine else "bitmap_fit_rounds_blocked"
    with recording(entry) as calls:
        advance(n)
    print_traffic(f"Exp5, {'airlock' if airlock else 'kernel-oom'}, ticks {t - n} to {t - 1}, "
                  f"{entry}", rounds_traffic(calls[entry]))
    return 0


def profile_batch(airlock: bool, B: int) -> int:
    """:func:`profile` of the lockstep tick of B seeds."""
    cfg = exp5_config(airlock)
    advance = batch_ticker(cfg, list(range(B)))
    advance(WARMUP_TICKS)
    torch.cuda.synchronize()
    n = WINDOW_TICKS
    t0 = time.perf_counter()
    advance(n)
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    print(f"profile_tick: lockstep batch of {B} seeds, {'airlock' if airlock else 'kernel-oom'}, "
          f"{cfg.num_nodes} nodes, {cfg.probe_capacity} slots, after {WARMUP_TICKS} ticks")
    print(f"host: enqueue {t_enq / n * 1e3:.3f} ms/tick, finished {t_all / n * 1e3:.3f} ms/tick "
          f"({n / t_all:.1f} ticks/s, {B * n / t_all:.1f} seed-ticks/s)")
    print_window(window(advance, n))
    eng = LaminarEngine(cfg, device="cuda")
    sb, lam = eng.init_batch(list(range(B)))
    draws = BatchDraws([eng.draws(lam, sb.zstart.shape[1], sd) for sd in range(B)])
    print_replayed(replayed_window(eng, sb, draws, lockstep=True))
    entry = "bitmap_fit_rounds"
    with recording(entry) as calls:
        advance(n)
    tick = WARMUP_TICKS + 2 * n
    print_traffic(f"Exp5, {'airlock' if airlock else 'kernel-oom'}, ticks {tick} to "
                  f"{tick + n - 1}, {entry}, a seed", rounds_traffic(per_seed_calls(calls[entry])))
    return 0


def replayed_window(eng, s, draws, lockstep: bool, warmup: int = WARMUP_TICKS,
                    n: int = WINDOW_TICKS) -> dict:
    """The replayed tick: ``warmup`` ticks from ``s`` through ``simulate``
    (``simulate_batch`` if ``lockstep``), which captures the tick, then
    ``n`` replays of its graph timed on the host clock (enqueue, and to the
    device's end) and ``n`` more under :func:`window`; with the graph's
    nodes (``kernel_bench.graph_census``) and the hand-written entries its
    kernel nodes launch."""
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census, tick_entries

    run = eng.simulate_batch if lockstep else eng.simulate
    with watching() as runs:
        run(s, draws, warmup)
    ((compiled, _),) = runs

    def advance(k):
        for _ in range(k):
            compiled.graph.replay()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    advance(n)
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    census = graph_census(compiled.graph)
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine

    seeds = s.st.shape[0] if lockstep else 1
    label = f"lockstep, B = {seeds}" if lockstep else (
        "sharded" if isinstance(eng, ZoneShardedEngine) else "flat")
    return dict(window(advance, n), enqueue_ms=t_enq / n * 1e3, finished_ms=t_all / n * 1e3,
                census=census, entries=tick_entries(census["names"]),
                label=label, seeds=seeds)


def print_replayed(w: dict) -> None:
    c = w["census"]
    seeds = w["seeds"]
    print(f"replayed tick ({w['label']}; "
          f"core.scan's graph): host enqueue {w['enqueue_ms']:.3f} ms/replay, finished "
          f"{w['finished_ms']:.3f} ms/replay ({1e3 / w['finished_ms']:.1f} ticks/s, "
          f"{seeds * 1e3 / w['finished_ms']:.1f} seed-ticks/s); graph nodes: {c['kernel']} "
          f"kernel ({c['nccl']} NCCL), {c['memcpy']} memcpy ({c['host_memcpy']} touching host "
          f"memory), {c['memset']} memset, {c['other']} other; hand-written kernel nodes "
          f"{w['entries']}")
    print_window(w)


def window(advance, n: int) -> dict:
    """``advance(n)`` under ``torch.profiler``, a tick on average: wall ms,
    device kernels and busy ms (``busy`` None where the profiler recorded no
    device event: not measured), aten ops (nested ones included), the
    device time of the largest kernels and of each hand-written kernel, and
    the host ops of the most self time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        advance(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = defaultdict(float)
    dev_n = 0
    hand = {k: [0, 0.0] for k in HAND_WRITTEN}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[e.name] += e.time_range.elapsed_us()
            dev_n += 1
            for k in HAND_WRITTEN:
                if k in e.name:
                    hand[k][0] += 1
                    hand[k][1] += e.time_range.elapsed_us()
    ka = prof.key_averages()
    return dict(
        ticks=n, wall_ms=wall / n * 1e3, kernels=dev_n / n,
        busy_ms=sum(dev_us.values()) / 1e3 / n if dev_n else None,
        aten_ops=sum(e.count for e in ka if e.key.startswith("aten::")) / n,
        top_device=[(name, us / n) for name, us in
                    sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]],
        hand_written={k: (c / n, us / n) for k, (c, us) in hand.items()},
        top_host=[(e.key, e.self_cpu_time_total / n, e.count / n)
                  for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:12]],
    )


def print_window(w: dict) -> None:
    if w["busy_ms"] is None:
        print("profiler: no device events recorded (device time not measured)")
    else:
        busy = w["busy_ms"] / w["wall_ms"]
        print(f"profiler window: {w['wall_ms']:.3f} ms/tick wall, {w['kernels']:.0f} device "
              f"kernels/tick, device busy {w['busy_ms']:.3f} ms/tick = {busy:.1%} of wall "
              f"(idle {1 - busy:.1%})")
        for name, us in w["top_device"]:
            print(f"  device {us:9.1f} us/tick  {name[:90]}")
        for kname, (launches, us) in w["hand_written"].items():
            print(f"  hand-written {kname}: {launches:.1f} launches/tick, "
                  f"{us:.3f} us/tick device time")
    print(f"host: {w['aten_ops']:.0f} aten ops/tick (nested ones included)")
    for key, us, calls in w["top_host"]:
        print(f"  host {us:9.1f} us/tick self, {calls:6.1f} calls/tick  {key[:70]}")


@contextmanager
def counting_gathers():
    """Count the ``torch.distributed.all_gather_into_tensor`` calls (the
    sharded tick's gathers) made while the block runs, into the list it
    yields (one entry a call). A replayed graph makes none: its gathers
    were recorded at the capture."""
    import torch.distributed as dist

    calls = []
    real = dist.all_gather_into_tensor

    def count(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    dist.all_gather_into_tensor = count
    try:
        yield calls
    finally:
        dist.all_gather_into_tensor = real


if __name__ == "__main__":
    sys.exit(main())
