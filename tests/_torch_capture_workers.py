"""Rank functions for ``tests/test_torch_capture_sharded.py``, run by
``repro_torch.parallel.local.spawn_ranks`` in fresh processes (so this
module imports no JAX). Each returns plain Python values and numpy arrays;
what must agree across ranks is returned whole."""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from repro_torch.core import LaminarConfig, MemoryConfig
from repro_torch.core.engine import make_step
from repro_torch.core.scan import watching
from repro_torch.parallel.engine_mesh import ZoneShardedEngine
from repro_torch.workloads import SCENARIOS

SMALL = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
                      horizon_ms=40.0, rho=0.8, memory=MemoryConfig(enabled=True))
# seeds 0 and 8 at 64 nodes: zones of (34, 30) and (30, 34) nodes, both
# (Z, M) = (2, 34), so one key of shapes and two geometries
GEOMETRY_SEEDS = (0, 8)


def config(case: str) -> LaminarConfig:
    """Exp5's settings at 64 nodes (Airlock off for ``kernel-oom``), or a
    scenario preset with Airlock on."""
    scenario = SCENARIOS[case] if case in SCENARIOS else SCENARIOS["stationary"]
    return dataclasses.replace(SMALL, airlock=case != "kernel-oom", scenario=scenario)


def eager(step, s, draws, ticks):
    """``step`` driven by hand: the loop the compiled run replaces."""
    rows = []
    for t in range(ticks):
        s, y = step(s, draws.tick(t))
        rows.append(y)
    return s, torch.stack(rows)


def leaves(s) -> list:
    return [x.numpy().copy() for x in pytree.tree_flatten(s)[0]]


def compiled_and_eager(dev, case: str, ticks: int, seed: int = 0, eng=None) -> dict:
    """One run of ``ZoneShardedEngine.simulate`` (the compiled body) and the
    eager ``make_step`` loop with this rank's plane, from the same state and
    two providers of one seed: both series, both final states, both
    providers' generator states, and the compiled runs the run made."""
    cfg = config(case)
    eng = eng or ZoneShardedEngine(cfg, device=dev)
    s, lam = eng.init(seed)
    a, b = (eng.draws(lam, s.zstart.shape[0], seed) for _ in range(2))
    with watching() as runs:
        final, ts = eng.simulate(s, a, ticks)
    efinal, ets = eager(make_step(cfg, plane=eng._plane(s)), s, b, ticks)
    return {"ts": ts.numpy(), "eager_ts": ets.numpy(), "state": leaves(final),
            "eager_state": leaves(efinal), "gen": a.gen.get_state().numpy(),
            "eager_gen": b.gen.get_state().numpy(), "compiled": len({id(c) for c, _ in runs}),
            "zcount": s.zcount.numpy()}


def sharded_cases(dev, cases, ticks) -> dict:
    """:func:`compiled_and_eager` for each case; ``"airlock"`` as the
    :data:`GEOMETRY_SEEDS` through one engine (``"geometry"``, with the
    engine's count of compiled ticks); the two gather forms on this rank's
    block (``"gather"``)."""
    out = {case: compiled_and_eager(dev, case, ticks) for case in cases if case != "airlock"}
    eng = ZoneShardedEngine(config("airlock"), device=dev)
    out["geometry"] = [compiled_and_eager(dev, "airlock", ticks, seed=sd, eng=eng)
                       for sd in GEOMETRY_SEEDS]
    out["airlock"] = out["geometry"][0]
    out["geometry_compiled"] = len(eng._compiled)
    plane = eng._plane(eng.init(0)[0])
    # three rows a rank (the plane's blocks have one here), so the order of
    # rows inside a block shows too
    x_l = (torch.arange(3 * 8 * 3, dtype=torch.int32).reshape(3, 8, 3)
           + 1000 * (dist.get_rank() + 1))
    listed = torch.empty((plane.D,) + tuple(x_l.shape), dtype=x_l.dtype)
    dist.all_gather(list(listed.unbind(0)), x_l)
    out["gather"] = {"into_tensor": plane._gather(x_l).numpy(),
                     "list": listed.reshape(-1, 8, 3).numpy()}
    return out
