"""Run the zone-sharded engine as D local processes, one rank each.

    python -m repro_torch.parallel.local --ranks 2 --nodes 72 --zone-size 32 \\
        --scenario storm --ticks 200 [--device cpu]

Each rank is a fresh process (``spawn``) that joins a process group through
a ``FileStore`` in a temporary directory (no TCP port, so concurrent runs do
not collide): NCCL on CUDA (the default) with rank ``r`` on ``cuda:r``, gloo
with one intra-op thread per rank when the caller asks for the CPU.
Every rank runs ``ZoneShardedEngine.run`` with the same arguments and writes
its ``summarize()`` dict; :func:`run_local` returns all of them, in rank
order. They are equal when the ranks stayed replicas. The run is compiled
(``core.scan``): under NCCL every rank captures one tick, its collectives
included, as a CUDA graph and replays it; under gloo the same body runs in
a loop. :func:`spawn_ranks` is the same harness for any function (the
mesh-aware trainer's tests).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time
from typing import Any, Dict, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.config import LaminarConfig, MemoryConfig
from repro_torch.core.draws import ArrayDraws
from repro_torch.workloads.scenario import SCENARIOS

TIMEOUT_S = 900.0  # a run still going after this is killed


def _rank_main(rank, world, tmp, device, fn, args):
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev, backend = f"cuda:{rank}", "nccl"
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
        dev, backend = "cpu", "gloo"
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        out = fn(dev, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, num_ranks: int, args=(), device: str = "cuda") -> List[Any]:
    """``fn(device, *args)`` on ``num_ranks`` local processes, each a rank of
    one process group (destroyed when ``fn`` returns); returns every rank's
    result (picklable), in rank order. ``fn`` must be importable by name.
    ``device`` defaults to ``"cuda"`` (rank ``r`` on ``cuda:r``, NCCL) and
    raises without CUDA, unless the caller asks for ``"cpu"`` (gloo).
    Raises if a rank fails or the ranks outlast ``TIMEOUT_S``."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spawn_ranks: CUDA is not available; pass device='cpu' to run the ranks "
            "on the CPU under gloo"
        )
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main,
            args=(num_ranks, tmp, device, fn, tuple(args)),
            nprocs=num_ranks,
            join=False,
            start_method="spawn",
        )
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=5.0):  # raises if a rank failed
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join(10.0)
                raise TimeoutError(f"spawn_ranks: ranks still running after {TIMEOUT_S} s")
        outs = []
        for r in range(num_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    return outs


def _engine_rank(dev, cfg, world, seed, num_ticks, draws, scenario):
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine

    eng = ZoneShardedEngine(cfg, num_devices=world, device=dev)
    if draws is not None:
        draws = ArrayDraws(draws.arrays, dev)
    return eng.run(seed=seed, num_ticks=num_ticks, scenario=scenario, draws=draws)


def run_local(
    cfg: LaminarConfig,
    num_ranks: int,
    seed: int = 0,
    num_ticks: int | None = None,
    draws: ArrayDraws | None = None,
    device: str = "cuda",
    scenario=None,
) -> List[Dict[str, Any]]:
    """Run the sharded engine on ``num_ranks`` local processes.

    ``device`` defaults to ``"cuda"`` (one card per rank) and raises without
    CUDA, unless the caller asks for ``"cpu"`` (gloo, the plain versions).
    ``draws``: recorded draws for every rank (default: each rank's
    ``TorchDraws`` from ``seed``). ``scenario``: the scenario run (default
    ``cfg.scenario``). Raises if a rank fails or the run outlasts
    ``TIMEOUT_S``."""
    return spawn_ranks(_engine_rank, num_ranks,
                       (cfg, num_ranks, seed, num_ticks, draws, scenario), device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--zone-size", type=int, default=32)
    ap.add_argument("--slots", type=int, default=1024, help="probe capacity")
    ap.add_argument("--arrivals", type=int, default=64, help="max arrivals per tick")
    ap.add_argument("--scenario", default="storm", choices=sorted(SCENARIOS))
    ap.add_argument("--airlock", action="store_true")
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    cfg = LaminarConfig(
        num_nodes=args.nodes, zone_size=args.zone_size, probe_capacity=args.slots,
        max_arrivals_per_tick=args.arrivals, rho=0.8, airlock=args.airlock,
        memory=MemoryConfig(enabled=True), scenario=SCENARIOS[args.scenario],
    )
    t0 = time.perf_counter()
    outs = run_local(cfg, args.ranks, seed=args.seed, num_ticks=args.ticks, device=args.device)
    wall = time.perf_counter() - t0
    o = outs[0]
    same = all(
        {k: v for k, v in x.items() if isinstance(v, int)}
        == {k: v for k, v in o.items() if isinstance(v, int)}
        for x in outs
    )
    print(f"{args.ranks} ranks on {args.device}, {args.ticks} ticks in {wall:.1f} s: "
          f"arrived={o['arrived']} started={o['started']} completed={o['completed']} "
          f"node_failures={o['node_failures']} evicted={o['evicted']} "
          f"exec_survival_ratio={o['exec_survival_ratio']:.6f} ranks_equal={same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
