"""Device time of ``survival_scan`` on the card, by launch; or of
``bitmap_fit_rounds``; or of ``utility_topk_address`` and
``zone_aggregate_members``; or of the lockstep tick's entries with a seed
axis.

    python -m repro_torch.kernel_bench [--phases] [--out FILE]
    python -m repro_torch.kernel_bench --rounds [--parent PATH] [--out FILE]
    python -m repro_torch.kernel_bench --rounds --sharded [--out FILE]
    python -m repro_torch.kernel_bench --address [--parent PATH] [--out FILE]
    python -m repro_torch.kernel_bench --batch B [--parent DIR] [--out FILE]

At the survival_scan shapes of ``chip_smoke.py`` phase 2 (Exp5: 5000 nodes,
65 536 probe slots; Exp7's top cell: 65 536 nodes, 131 072 slots), Airlock
on and off, with the inputs phase 2 draws (seeded numpy):

  * the port's kernel through its wrapper's launch function and plan: device
    ms of one call, as ``chip_smoke.py`` times it (20 calls captured in a CUDA
    graph and replayed, median of 5 replays; inputs warm in L2), and the
    device time of each of its kernels (``torch.profiler`` over 50 eager
    calls: the sum of each kernel's own device durations per call);
  * with ``--phases``, the port's source built again with
    ``-DSURVIVAL_SCAN_PHASES``: the SM cycles each phase of the cluster
    kernel takes (the most over its 16 CTAs), between the stamps thread 0 of
    each CTA takes at the ends of the phases and around each cluster
    barrier; and the graph-replay ms of that build.

With ``--rounds``, ``bitmap_fit_rounds`` instead, on the inputs the flat
engine's tick really gives it (``profile_tick.tick_rounds``): Exp5 (kernel
OOM and Airlock, ticks 200 to 219, as ``profile_tick`` reads them) and
Exp7's top cell (ticks 80 to 99 of its 100). For each, what the tick gives
the rounds (``profile_tick.rounds_traffic``: queued slots, winners, free
runs of the nodes that reach the allocation), then the graph-replay device
ms of one call, the median over the 20 ticks' inputs, of the port's kernel
and, with ``--parent PATH``, of another ``bitmap_fit.cu`` with the same
``bitmap_fit_rounds_launch`` (checked equal to the port's outputs on every
tick), in the order parent, port, port, parent; and the plain version's on
the last tick. The inputs and corner cases of its tests
(``rounds_inputs``, ``rounds_edge_cases``) live here too.

With ``--rounds --sharded``, ``bitmap_fit_rounds_blocked`` on the inputs the
zone-sharded tick gives it on one rank (a one-rank NCCL group): Exp5
stationary and Exp6's storm at its 2400-tick geometry (the same 5000 nodes,
20 x 301 block), kernel OOM and Airlock, ticks 200 to 219. For each, the
traffic (:func:`profile_tick.rounds_traffic` on the block), then the
graph-replay device ms of one call, the median over the 20 ticks (checked
equal to the tick's outputs), and the plain version's on the last tick. The
inputs of its tests (``blocked_split``, ``rounds_blocked_edge_cases``,
``blocked_rounds_shapes``) live here too.

With ``--address``, ``utility_topk_address`` (the DA addressing step in one
launch) on the same 20 ticks of the same cells: what the tick gives it
(:func:`address_traffic`: addressing slots, the warps that hold one, the
sampled candidates whose reports are stale), the graph-replay device ms of
one call, the median over the 20 ticks, of the port's kernel and, with
``--parent PATH``, of another ``utility_topk.cu`` with the same
``utility_topk_address_launch`` (checked equal to the tick's outputs), in
the order parent, port, port, parent; the plain version's on the last
tick; and ``zone_aggregate_members``' (the TEG refresh in one launch),
the median over the refresh ticks and over the others. First the tile
entry ``utility_topk`` of the port and of the parent (a source that lacks
the addressing entry, such as an older one, is timed on the tile alone).
Its inputs and corner cases (``address_inputs``, ``address_edge_cases``)
live here too.

With ``--batch B``, the five entries of the lockstep tick
(``kernels.LOCKSTEP``) on the inputs the lockstep tick of B seeds gives
them at Exp5 (Airlock on, tick 200, seeds 0 to B - 1): the graph-replay
device ms of one call with the seed axis, checked equal to the B seeds'
calls without one, against those B launches, of the port and, with
``--parent DIR`` (a directory holding the sources of an earlier tree, e.g.
its ``csrc``), of that build, in the order parent, port, port, parent.

Prints one line per measurement, the card's name and power limit, and writes
the numbers as JSON to ``--out`` (default ``build/kernel_bench.json``).
Needs a CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch import profile_tick
from repro_torch.core.state import QUEUED
from repro_torch.kernels import _build
from repro_torch.kernels.survival_scan import ops as surv_ops
from repro_torch.kernels.survival_scan import plan as surv_plan
from repro_torch.kernels.utility_topk.ref import address_view

GEOMETRIES = {"Exp5": (5000, 65536), "Exp7": (65536, 131072)}  # (N, P)
KW = dict(residual=0.3, watermark=0.9, safe=0.8, t_susp=80, t_surv=240)


def inputs(N: int, P: int, seed: int, dev):
    """The survival_scan case of ``chip_smoke.py``'s ``kernel_cases``."""
    rng = np.random.default_rng(seed)
    st = rng.choice([0, 4, 6, 7], size=P, p=[0.3, 0.1, 0.5, 0.1]).astype(np.int32)
    cols = (
        st, np.where(st != 0, rng.integers(0, N, P), -1).astype(np.int32),
        rng.uniform(0, 0.1, P).astype(np.float32),
        rng.choice([24.0, 48.0, 96.0, 256.0], P).astype(np.float32),
        rng.integers(0, 3, P).astype(np.int32), rng.uniform(size=P) < 0.1,
        rng.integers(0, 300, P).astype(np.int32), rng.integers(100, 600, P).astype(np.int32),
        rng.uniform(0.2, 0.8, N).astype(np.float32),
    )
    return tuple(torch.from_numpy(c).to(dev) for c in cols) + (
        torch.tensor(300, dtype=torch.int32, device=dev),)


def edge_cases(seed: int = 0) -> dict:
    """survival_scan inputs (CPU tensors) that stress the one-cluster
    design's corners, by name: scores tied at -0.0 / +0.0 (``ev`` and
    ``mem`` both signed zeros, every node over the watermark), scores of
    +-inf, one node holding a fifth of all slots, an all-empty table, every
    slot on one node, and Exp7's top-cell shape."""
    rng = np.random.default_rng(seed)
    out = {}

    def table(N, P):
        st = rng.choice([0, 4, 6, 7], size=P, p=[0.3, 0.1, 0.5, 0.1]).astype(np.int32)
        return dict(
            st=st, node=np.where(st != 0, rng.integers(0, N, P), -1).astype(np.int32),
            mem=rng.uniform(0, 0.1, P).astype(np.float32),
            ev=rng.choice([24.0, 48.0, 96.0, 256.0], P).astype(np.float32),
            tier=rng.integers(0, 3, P).astype(np.int32), mig=rng.uniform(size=P) < 0.1,
            stick=rng.integers(0, 300, P).astype(np.int32),
            sdl=rng.integers(100, 600, P).astype(np.int32),
            base=rng.uniform(0.2, 0.8, N).astype(np.float32))

    c = table(64, 4096)  # every slot resident, every node over the watermark
    c.update(st=np.full(4096, 6, np.int32), node=rng.integers(0, 64, 4096).astype(np.int32),
             tier=np.ones(4096, np.int32), base=np.full(64, 1.5, np.float32))
    c["ev"] = np.where(rng.uniform(size=4096) < 0.5, 0.0, -0.0).astype(np.float32)
    c["mem"] = np.where(rng.uniform(size=4096) < 0.5, 0.0, -0.0).astype(np.float32)
    out["zero_ties"] = c
    c = table(64, 4096)
    c.update(base=np.full(64, 1.5, np.float32))
    c["ev"] = rng.choice(np.array([np.inf, -np.inf, 24.0, 48.0], np.float32), 4096)
    c["mem"] = rng.choice(np.array([np.inf, 0.05, 0.01], np.float32), 4096)
    out["inf_scores"] = c
    c = table(5000, 65536)
    c["node"][rng.permutation(65536)[: 65536 // 5]] = 17
    out["fifth_on_one"] = c
    c = table(5000, 65536)
    c.update(st=np.zeros(65536, np.int32), node=np.full(65536, -1, np.int32),
             mig=np.zeros(65536, bool))
    out["all_empty"] = c
    c = table(5000, 65536)
    c["node"][:] = 3
    out["all_on_one"] = c
    out["exp7"] = table(65536, 131072)
    keys = ("st", "node", "mem", "ev", "tier", "mig", "stick", "sdl", "base")
    return {name: tuple(torch.from_numpy(np.ascontiguousarray(c[k])) for k in keys)
            + (torch.tensor(300, dtype=torch.int32),) for name, c in out.items()}


def rounds_inputs(N: int, P: int, W: int = 2, atoms: int | None = None, seed: int = 0,
                  queued: float = 0.02, policy: str = "best", rounds: int = 3):
    """``bitmap_fit_rounds`` inputs (CPU tensors) and keywords at one shape:
    ``queued`` of the slots queued on random nodes, E_v from a few values (so
    ties happen), demands of 1 to 16 atoms and some up to the node's atoms,
    a fifth contiguous, node words from full to sparse (no bit past
    ``atoms``), a tenth of the nodes throttled."""
    A = 32 * W if atoms is None else atoms
    rng = np.random.default_rng(seed)
    st = np.where(rng.uniform(size=P) < queued, QUEUED,
                  rng.choice([0, 2, 5, 6], size=P)).astype(np.int32)
    node = rng.integers(0, N, P).astype(np.int32)
    ev = (rng.choice([24.0, 48.0, 96.0, 256.0], P)
          * rng.choice([1.0, 1.0, 1.5], P)).astype(np.float32)
    mass = np.where(rng.uniform(size=P) < 0.9, rng.integers(1, 17, P),
                    rng.integers(1, A + 1, P)).astype(np.int32)
    contig = rng.uniform(size=P) < 0.2
    bits = rng.uniform(size=(N, A)) < rng.choice([0.3, 0.7, 0.95, 1.0], size=(N, 1))
    throttled = rng.uniform(size=N) < 0.1
    return rounds_tensors(st, node, ev, mass, contig, bits, throttled, W), dict(
        rounds=rounds, atoms=A, policy=policy)


def rounds_tensors(st, node, ev, mass, contig, bits, throttled, W):
    """numpy columns and an (N, A) bool plane -> the kernel's CPU tensors."""
    N, A = bits.shape
    plane = np.zeros((N, 32 * W), bool)
    plane[:, :A] = bits
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)  # bit k of word w: atom 32 w + k
    words = (plane.reshape(N, W, 32) * weights).sum(-1).astype(np.uint32)
    t = torch.from_numpy
    return (t(np.asarray(st, np.int32)), t(np.asarray(node, np.int32)),
            t(np.asarray(ev, np.float32)), t(np.asarray(mass, np.int32)),
            t(np.asarray(contig, bool)), t(words.view(np.int32)), t(np.asarray(throttled, bool)))


def rounds_edge_cases(seed: int = 0) -> dict:
    """``bitmap_fit_rounds`` inputs (CPU tensors, keywords) at the corners of
    its design, by name: E_v ties (the slot tiebreak); +-inf and signed-zero
    E_v; a queued NaN; half the nodes throttled; nodes with fewer queued
    probes than rounds and one node with every probe queued on it;
    contiguous and dispersed demands of 0 and past the node's atoms; 48
    atoms a node; 3 and 8 words a node; the "first" policy; and every probe
    queued at Exp7's shape."""
    rng = np.random.default_rng(seed)
    out = {}

    def base(N, P, W=2, atoms=None, **kw):
        args, k = rounds_inputs(N, P, W, atoms, seed=int(rng.integers(1 << 30)), **kw)
        return [a.numpy().copy() for a in args], k

    def put(name, cols, kw):
        out[name] = (tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in cols), kw)

    cols, kw = base(64, 4096, queued=0.5)
    cols[2][:] = rng.choice([48.0, 96.0], 4096)  # two values only: ties everywhere
    put("ev_ties", cols, kw)
    cols, kw = base(64, 4096, queued=0.3)
    cols[2][:] = rng.choice(np.array([np.inf, -np.inf, 0.0, -0.0, 24.0, -24.0], np.float32),
                            4096, p=[0.01, 0.2, 0.3, 0.3, 0.1, 0.09])
    put("inf_and_signed_zero", cols, kw)
    cols, kw = base(64, 4096, queued=0.3)
    cols[2][rng.permutation(4096)[:12]] = np.nan
    put("nan", cols, kw)
    cols, kw = base(300, 8192, queued=0.2)
    cols[6][:] = rng.uniform(size=300) < 0.5
    put("half_throttled", cols, kw)
    cols, kw = base(37, 1029, queued=0.0)
    st, node = cols[0], cols[1]
    for n, k in ((0, 1), (1, 2), (2, 3), (3, 4)):  # fewer queued probes than rounds, and more
        idx = rng.permutation(np.nonzero(st != QUEUED)[0])[:k]
        st[idx], node[idx] = QUEUED, n
    put("few_queued", cols, kw)
    cols, kw = base(37, 1029, queued=1.0)
    cols[1][:] = 5  # every probe queued on one node
    cols[6][:] = False
    put("all_on_one", cols, kw)
    cols, kw = base(64, 4096, queued=0.5)
    cols[3][:] = rng.choice([0, 1, 64, 65, 200, 3], 4096)
    cols[4][:] = rng.uniform(size=4096) < 0.5
    put("mass_0_and_past_atoms", cols, kw)
    put("atoms_48", *base(100, 2048, W=2, atoms=48, queued=0.3))
    put("words_3", *base(100, 2048, W=3, atoms=80, queued=0.3))
    put("words_8", *base(100, 2048, W=8, queued=0.3))
    put("first_fit", *base(300, 8192, queued=0.2, policy="first"))
    put("first_fit_words_8", *base(100, 2048, W=8, queued=0.3, policy="first"))
    put("exp7_all_queued", *base(65536, 131072, queued=1.0))
    return out


def jittered_counts(N: int, zone: int, seed: int = 0) -> np.ndarray:
    """Contiguous zone sizes summing to ``N``: a first zone of ``zone`` nodes
    (the block's width M), the others of ``zone // 2`` to ``zone``, so most
    zone rows end in padding slots."""
    rng = np.random.default_rng(seed)
    sizes = [min(zone, N)]
    left = N - sizes[0]
    while left > 0:
        sizes.append(min(left, int(rng.integers(max(1, zone // 2), zone + 1))))
        left -= sizes[-1]
    return np.asarray(sizes, np.int32)


def blocked_split(args, kw, counts, rank: int = 0, ranks: int = 1):
    """A ``bitmap_fit_rounds`` case on contiguous zones of ``counts`` nodes,
    as rank ``rank`` of ``ranks`` sees it: the arguments of
    ``bitmap_fit_rounds_blocked`` (the case's, then the rank's ``member``,
    ``mask`` and ``local``, CPU tensors) and the keywords."""
    from repro_torch.core.state import densify_zones
    from repro_torch.parallel.engine_mesh import zone_block

    counts = np.asarray(counts, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    member, mask = densify_zones(starts, counts)
    block = zone_block(torch.from_numpy(member), torch.from_numpy(mask), rank, ranks,
                       args[5].shape[0])
    return (*args, *block), kw


def rounds_blocked_edge_cases(seed: int = 0) -> dict:
    """``bitmap_fit_rounds_blocked`` inputs (CPU tensors, keywords) at the
    corners: each of :func:`rounds_edge_cases` on jittered zones (padding
    slots in most rows) as the one rank's block (``<name>/1``) and as each
    of two ranks' (``<name>/2:0``, ``<name>/2:1``: the other's nodes off the
    block; Exp7's shape on one rank only); and ``node0_beside_padding``, a third of
    the queued probes on node 0, whose zone row ends in padding slots that
    point at node 0 too, on one rank and as the first of two."""
    out = {}
    for i, (name, (args, kw)) in enumerate(rounds_edge_cases(seed).items()):
        N = args[5].shape[0]
        counts = jittered_counts(N, min(max(2, N // 5), 307), seed=seed + i)
        out[f"{name}/1"] = blocked_split(args, kw, counts)
        if not name.startswith("exp7"):
            for rank in (0, 1):
                out[f"{name}/2:{rank}"] = blocked_split(args, kw, counts, rank=rank, ranks=2)
    rng = np.random.default_rng(seed)
    args, kw = rounds_inputs(64, 4096, seed=int(rng.integers(1 << 30)), queued=0.3)
    node = args[1].clone()
    node[torch.from_numpy(rng.uniform(size=4096) < 0.3)] = 0
    args = (args[0], node, *args[2:])
    counts = np.array([9, 5, 12, 7, 12, 10, 9], np.int32)  # M = 12: node 0's row has 3 pads
    out["node0_beside_padding/1"] = blocked_split(args, kw, counts)
    out["node0_beside_padding/2:0"] = blocked_split(args, kw, counts, rank=0, ranks=2)
    return out


def blocked_rounds_shapes(seed: int = 0) -> dict:
    """``bitmap_fit_rounds_blocked`` inputs at the main paths' blocks, one
    rank, both policies: ragged (37 nodes in zones of up to 13, 1029 slots),
    Exp5 (20 x 301, 65 536 slots) and Exp7's top cell (253 x 307, 131 072
    slots), the zones as ``init_numpy`` lays them out."""
    from repro_torch.core.state import build_zones
    from repro_torch.profile_tick import exp5_config, exp7_config

    out = {}
    cells = {"ragged": (37, 1029, jittered_counts(37, 13, seed)),
             "exp5": (5000, 65536, build_zones(exp5_config(False), np.random.default_rng(0))[1]),
             "exp7": (65536, 131072, build_zones(exp7_config(), np.random.default_rng(0))[1])}
    for label, (N, P, counts) in cells.items():
        for policy in ("best", "first"):
            out[f"{label}-{policy}"] = blocked_split(
                *rounds_inputs(N, P, seed=N + seed, policy=policy), counts)
    return out


def address_inputs(N: int, P: int, K: int = 8, Z: int | None = None, seed: int = 0,
                   addressing: float = 0.01, t: int = 400) -> tuple:
    """``utility_topk_address`` inputs (CPU tensors, in the entry's order) at
    one shape: ``addressing`` of the slots ADDRESSING, the rest in other
    states; zones of random sizes tiling the N nodes; reported slack and
    heat with derivatives, reports up to 200 ticks old at tick ``t`` (past
    ``degrade_after_ms`` for some); true views near the reports; demands of
    1 to 16 atoms, a fifth contiguous; a tenth of the probes migrating;
    patience from 0 to 40. Keywords: :func:`address_kw`."""
    rng = np.random.default_rng(seed)
    Z = Z or max(1, N // 256)
    cuts = np.sort(rng.choice(np.arange(1, N), size=Z - 1, replace=False)) if Z > 1 else []
    zstart = np.concatenate([[0], cuts]).astype(np.int32)
    zcount = np.diff(np.concatenate([zstart, [N]])).astype(np.int32)
    zone_id = np.repeat(np.arange(Z, dtype=np.int32), zcount)
    st = np.where(rng.uniform(size=P) < addressing, 2,
                  rng.choice([0, 1, 3, 4, 6, 7], size=P)).astype(np.int32)
    zone = rng.integers(0, Z, P).astype(np.int32)
    node = (zstart[zone] + (rng.uniform(size=P) * zcount[zone]).astype(np.int32)).astype(np.int32)
    rep_S = rng.integers(0, 65, N).astype(np.float32)
    s_true = np.clip(rep_S + rng.integers(-4, 5, N), 0, 64).astype(np.float32)
    rep_run = np.minimum(rep_S, rng.integers(0, 65, N)).astype(np.float32)
    rep_H = rng.integers(0, 12, N).astype(np.float32)
    cols = dict(
        st=st, node=node, zone=zone, timer=rng.integers(0, 5, P).astype(np.int32),
        patience=rng.uniform(0, 40, P).astype(np.float32),
        migrating=rng.uniform(size=P) < 0.1, mass=rng.integers(1, 17, P).astype(np.int32),
        contig=rng.uniform(size=P) < 0.2,
        cand_u=rng.uniform(size=(P, K - 1)).astype(np.float32),
        addr_eps=rng.normal(size=(P, K)).astype(np.float32),
        zstart=zstart, zcount=zcount, zone_id=zone_id, rep_S=rep_S, rep_H=rep_H,
        rep_run=rep_run, rep_t=(t - rng.integers(0, 200, N)).astype(np.int32),
        dS=rng.normal(0, 0.3, N).astype(np.float32), dH=rng.normal(0, 0.1, N).astype(np.float32),
        s_true=s_true, h_true=np.maximum(rep_H + rng.integers(-2, 3, N), 0).astype(np.float32),
        run_true=np.minimum(s_true, rep_run).astype(np.float32),
        t=np.array(t, np.int32),
    )
    return address_tensors(cols)


def address_tensors(cols: dict) -> tuple:
    """The named numpy columns as the entry's argument tuple (CPU tensors)."""
    from repro_torch.kernels.utility_topk.plan import ADDRESS_INPUTS

    return tuple(torch.from_numpy(np.array(cols[name], order="C")) for name, _, _ in
                 ADDRESS_INPUTS)


def address_kw(**overrides) -> dict:
    """``utility_topk_address``'s keywords from the default config."""
    from repro_torch.core.config import LaminarConfig
    from repro_torch.core.hotpath import address_params

    return dict(address_params(LaminarConfig()), **overrides)


def members_inputs(N: int, Z: int, seed: int = 0, t: int | None = 40,
                   zones_seed: int | None = None) -> tuple:
    """``zone_aggregate_members`` inputs (CPU tensors): zones of random
    sizes tiling the N nodes (drawn from ``zones_seed``, default ``seed``),
    densified as the state lays them out, the reported slack and heat of the
    nodes, and with ``t`` the tick and the old table for the refresh select."""
    from repro_torch.core.state import densify_zones

    rng = np.random.default_rng(seed)
    geo = np.random.default_rng(seed if zones_seed is None else zones_seed)
    cuts = np.sort(geo.choice(np.arange(1, N), size=Z - 1, replace=False)) if Z > 1 else []
    zstart = np.concatenate([[0], cuts]).astype(np.int32)
    member, mask = densify_zones(zstart, np.diff(np.concatenate([zstart, [N]])).astype(np.int32))
    args = tuple(torch.from_numpy(x) for x in (rng.uniform(0, 64, N).astype(np.float32),
                                               rng.uniform(0, 16, N).astype(np.float32),
                                               member, mask))
    if t is None:
        return args
    return args + (torch.tensor(t, dtype=torch.int32),
                   *(torch.from_numpy(rng.uniform(0, 64, Z).astype(np.float32)) for _ in "SH"))


def pack_rows(bits: np.ndarray) -> torch.Tensor:
    """(n, 32 W) bool rows -> (n, W) int32 words, bit k of word w atom 32 w + k."""
    n, A = bits.shape
    pos = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (bits.reshape(n, A // 32, 32).astype(np.uint64) * pos).sum(-1)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def view_inputs(N: int, W: int = 2, atoms: int | None = None, seed: int = 0) -> tuple:
    """``node_view`` inputs (CPU tensors) and keywords at one shape: rows of
    every free density from a few free atoms to almost all (so runs of every
    length, across word boundaries too), a tenth of the rows all free and a
    tenth none; ``atoms`` (default ``32 W``) atoms a row, the bits past
    them random."""
    rng = np.random.default_rng(seed)
    atoms = 32 * W if atoms is None else atoms
    bits = rng.uniform(size=(N, 32 * W)) < rng.uniform(0.05, 0.99, (N, 1))
    kind = rng.uniform(size=N)
    bits[kind < 0.1] = True
    bits[(kind >= 0.1) & (kind < 0.2)] = False
    bits[:, atoms:] = rng.uniform(size=(N, 32 * W - atoms)) < 0.5
    return (pack_rows(bits),), dict(atoms=atoms)


def view_edge_cases(seed: int = 0) -> dict:
    """``node_view`` inputs (CPU tensors) at its corners, by name: every atom
    free, none free, one run across atoms 31 and 32, a run that ends at the
    top atom, alternating atoms, random words, and 48 or 80 atoms in 2 or 3
    words with random bits past them."""
    rng = np.random.default_rng(seed)
    out = {}

    def rows(n, W):
        return np.zeros((n, 32 * W), bool)

    out["all_free"] = (~rows(5, 2), 64)
    out["none_free"] = (rows(5, 2), 64)
    b = rows(32, 2)
    for i in range(32):  # [31 - i, 33 + i % 3): across the word boundary
        b[i, 31 - i: 33 + i % 3] = True
    out["across_31_32"] = (b, 64)
    b = rows(64, 2)
    for i in range(64):  # [i, 64) with a hole below it
        b[i, i:] = True
        b[i, : max(i - 1, 0)] = rng.uniform(size=max(i - 1, 0)) < 0.5
    out["to_the_top"] = (b, 64)
    b = rows(2, 2)
    b[0, 0::2] = b[1, 1::2] = True
    out["alternating"] = (b, 64)
    out["random"] = (rng.uniform(size=(300, 64)) < 0.5, 64)
    b = rng.uniform(size=(64, 64)) < 0.5
    b[:32, 16:48] = True  # runs reaching atom 47 and the garbage past it
    b[:, 48:] = rng.uniform(size=(64, 16)) < 0.9
    out["garbage_past_48"] = (b, 48)
    b = rng.uniform(size=(64, 96)) < 0.7
    b[:16] = True
    out["three_words_80"] = (b, 80)
    return {name: ((pack_rows(b),), dict(atoms=a)) for name, (b, a) in out.items()}


def batched_inputs(B: int, N: int = 37, P: int = 1029, K: int = 8, Z: int = 3, W: int = 2,
                   seed: int = 0, airlock: bool = True) -> dict:
    """The inputs of the lockstep tick's five entries with a seed axis (CPU
    tensors with a leading axis of B seeds, seed ``b`` drawn from
    ``seed + b``), at one shape: entry -> (args, kw). The ticks differ by
    seed (40, 41, ...: a refresh tick of
    ``every = 20`` and others)."""
    def stack(cases):
        cols = zip(*(args for args, _ in cases))
        return (tuple(torch.stack(xs) if isinstance(xs[0], torch.Tensor) else xs[0]
                      for xs in cols), cases[0][1])

    surv_kw = dict(KW, airlock=airlock, watermark=0.9 if airlock else 1.0)
    return {
        "bitmap_fit_rounds": stack([rounds_inputs(N, P, W, seed=seed + b, queued=0.2)
                                    for b in range(B)]),
        "utility_topk_address": stack([
            (address_inputs(N, P, K, Z, seed=seed + b, addressing=0.3, t=400 + b), address_kw())
            for b in range(B)]),
        "zone_aggregate_members": stack([
            (members_inputs(N, Z, seed=seed + b, t=40 + b, zones_seed=seed), dict(every=20))
            for b in range(B)]),
        "survival_scan": stack([(inputs(N, P, seed + b, "cpu"), surv_kw) for b in range(B)]),
        "node_view": stack([view_inputs(N, W, seed=seed + b) for b in range(B)]),
    }


def address_edge_cases(seed: int = 0) -> dict:
    """``utility_topk_address`` inputs (CPU tensors, keywords) at the corners
    of its design, by name: no slot addressing; every slot addressing; every
    candidate infeasible; score ties (equal views and no noise); launchpads
    of node -1; empty zones; migrating probes that Fast-Fail; bounces into
    another zone (zone ids that disagree with the zones' ranges); stale
    reports (every candidate degraded); no projection; a ragged K of 5."""
    from repro_torch.kernels.utility_topk.plan import ADDRESS_INPUTS

    rng = np.random.default_rng(seed)
    names = [name for name, _, _ in ADDRESS_INPUTS]
    out = {}

    def base(N=300, P=4099, K=8, Z=3, **kw):
        args = address_inputs(N, P, K, Z, seed=int(rng.integers(1 << 30)), **kw)
        return {n: a.numpy().copy() for n, a in zip(names, args)}

    def put(name, cols, **kw):
        out[name] = (address_tensors(cols), address_kw(**kw))

    put("none_addressing", base(addressing=0.0))
    put("all_addressing", base(addressing=1.0))
    c = base(addressing=0.5)
    c["mass"][:] = 1000  # past every slack and run
    put("all_infeasible", c)
    c = base(addressing=0.5)
    for k in ("rep_S", "s_true", "rep_run", "run_true"):
        c[k][:] = 32.0
    for k in ("rep_H", "h_true", "dS", "dH"):
        c[k][:] = 0.0
    c["rep_t"][:] = c["t"]
    c["addr_eps"][:] = 0.0
    put("score_ties", c)
    c = base(addressing=0.5)
    c["node"][:] = -1
    put("node_minus_1", c)
    c = base(N=300, Z=10, addressing=0.5)
    c["zcount"][::2] = 0  # every other zone empty; its probes sample its start
    put("empty_zones", c)
    c = base(addressing=0.5)
    c["migrating"][:] = True
    c["patience"][:] = rng.uniform(0, 5, c["patience"].shape).astype(np.float32)
    put("migrating_fastfail", c)
    c = base(N=300, Z=6, addressing=0.5)
    c["zone_id"] = rng.permutation(c["zone_id"]).astype(np.int32)
    put("bounce_other_zone", c)
    c = base(addressing=0.5)
    c["rep_t"][:] = c["t"] - rng.integers(100, 2000, c["rep_t"].shape)
    put("stale_reports", c)
    put("no_projection", base(addressing=0.5), projection=False)
    put("k_5", base(P=1029, K=5, addressing=0.5))
    return out


def graph_ms(fn, reps=20, rounds=5) -> float:
    """Device ms of one call: ``reps`` calls in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out))


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _kernel_name(cu, node) -> str:
    """The (mangled) function name of a kernel node: ``cuFuncGetName`` of
    its function, or ``cuKernelGetName`` where the runtime launched a
    library kernel."""
    params = _KernelNodeParams()
    if cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)) != 0:
        raise RuntimeError("cuGraphKernelNodeGetParams failed")
    name = ctypes.c_char_p()
    if params.func and cu.cuFuncGetName(ctypes.byref(name),
                                        ctypes.c_void_p(params.func)) == 0:
        return name.value.decode()
    if params.kern and cu.cuKernelGetName(ctypes.byref(name),
                                          ctypes.c_void_p(params.kern)) == 0:
        return name.value.decode()
    raise RuntimeError("a kernel node without a function name")


class _Memcpy3D(ctypes.Structure):
    """``CUDA_MEMCPY3D`` (cuda.h)."""

    _fields_ = [("src_x", ctypes.c_size_t), ("src_y", ctypes.c_size_t),
                ("src_z", ctypes.c_size_t), ("src_lod", ctypes.c_size_t),
                ("src_type", ctypes.c_int), ("src_host", ctypes.c_void_p),
                ("src_device", ctypes.c_void_p), ("src_array", ctypes.c_void_p),
                ("reserved0", ctypes.c_void_p), ("src_pitch", ctypes.c_size_t),
                ("src_height", ctypes.c_size_t), ("dst_x", ctypes.c_size_t),
                ("dst_y", ctypes.c_size_t), ("dst_z", ctypes.c_size_t),
                ("dst_lod", ctypes.c_size_t), ("dst_type", ctypes.c_int),
                ("dst_host", ctypes.c_void_p), ("dst_device", ctypes.c_void_p),
                ("dst_array", ctypes.c_void_p), ("reserved1", ctypes.c_void_p),
                ("dst_pitch", ctypes.c_size_t), ("dst_height", ctypes.c_size_t),
                ("width", ctypes.c_size_t), ("height", ctypes.c_size_t),
                ("depth", ctypes.c_size_t)]


_HOST, _UNIFIED = 1, 4  # CUmemorytype
_POINTER_MEMORY_TYPE = 2  # CU_POINTER_ATTRIBUTE_MEMORY_TYPE


def _touches_host(cu, node) -> bool:
    """Whether a memcpy node reads or writes host memory."""
    p = _Memcpy3D()
    if cu.cuGraphMemcpyNodeGetParams(node, ctypes.byref(p)) != 0:
        raise RuntimeError("cuGraphMemcpyNodeGetParams failed")
    for kind, ptr in ((p.src_type, p.src_device or p.src_host),
                      (p.dst_type, p.dst_device or p.dst_host)):
        if kind == _UNIFIED:  # a unified address: ask what it points at
            at = ctypes.c_uint(0)
            cu.cuPointerGetAttribute(ctypes.byref(at), _POINTER_MEMORY_TYPE,
                                     ctypes.c_void_p(ptr))
            kind = at.value
        if kind == _HOST:
            return True
    return False


def graph_census(graph: torch.cuda.CUDAGraph) -> dict:
    """The nodes of a captured CUDA graph kept by its capture
    (``keep_graph=True``), through ``libcuda`` (``cuGraphGetNodes``):
    counts by type (``kernel``, ``memcpy``, ``memset``, ``other``),
    ``host_memcpy`` (memcpy nodes that read or write host memory), ``nccl``
    (the kernel nodes of NCCL's collectives, ``nccl*`` functions: counted
    among ``kernel`` too, apart from the hand-written ones) and ``names``,
    the function name of each kernel node."""
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    out = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0, "host_memcpy": 0, "nccl": 0,
           "names": []}
    kinds = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType
    for node in nodes:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        out[kinds.get(t.value, "other")] += 1
        if t.value == 0:
            out["names"].append(_kernel_name(cu, ctypes.c_void_p(node)))
            out["nccl"] += "nccl" in out["names"][-1].lower()
        elif t.value == 1:
            out["host_memcpy"] += _touches_host(cu, ctypes.c_void_p(node))
    return out


def tick_entries(names) -> dict:
    """The hand-written entries that kernel nodes ``names`` (a graph's)
    launch, by entry (``kernels.entry_of``: a kernel a tick launches counts
    under that tick's entry, with or without a seed axis; another
    hand-written kernel under its own name, so that a check against the
    tick's entries fails on it); NCCL's kernels are none (``graph_census``
    counts them)."""
    from repro_torch.kernels import entry_of

    out: dict = {}
    for entry in filter(None, map(entry_of, names)):
        out[entry] = out.get(entry, 0) + 1
    return out


def graph_nodes(fn, kernel_names: list | None = None) -> dict:
    """The device work one call of ``fn`` enqueues: the call captured in a
    CUDA graph (``torch.cuda.graph``), its nodes counted by type
    (:func:`graph_census`): ``kernel``, ``memset``, ``memcpy`` and
    ``other``. Warms ``fn`` up first, outside the capture. Appends each
    kernel node's function name to ``kernel_names`` when given."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    torch.cuda.synchronize()
    census = graph_census(g)
    if kernel_names is not None:
        kernel_names.extend(census["names"])
    g.reset()
    return {k: census[k] for k in ("kernel", "memcpy", "memset", "other")}


def per_kernel_ms(fn, calls=50) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and ev.count >= calls:
            out[ev.key] = dev_us / 1e3 / calls
    return out


PHASES = ("read, count, scan over warps, push counts", "barrier 1", "offsets, place entries",
          "barrier 2", "fold, victim keys, mask words", "barrier 3", "masks")


def build_lib(path: Path, name: str, *flags: str) -> ctypes.CDLL:
    """``path`` built with the port's nvcc flags (and ``flags``) into
    ``build/<name>/``, loaded."""
    out_dir = _build.BUILD_DIR.parent / name
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(path)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


class Phases:
    """The port's kernel with phase stamps (``-DSURVIVAL_SCAN_PHASES``)."""

    def __init__(self):
        self.lib = build_lib(_build.CSRC / "survival_scan.cu", "phases", "-DSURVIVAL_SCAN_PHASES")
        for fn, argtypes in surv_ops._SIG.items():
            getattr(self.lib, fn).argtypes = argtypes
        self.lib.survival_scan_phases.argtypes = [ctypes.c_void_p]

    def call(self, args, airlock: bool):
        kw = dict(KW, airlock=airlock)
        plan = surv_plan.for_call(*args, **kw)
        outs = plan.new_outputs(args[0].device)
        scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=args[0].device)
        err = self.lib.survival_scan_launch(
            *(_build.ptr(x) for x in (*args, *outs, scratch)), args[0].shape[0],
            args[8].shape[0], int(airlock), KW["residual"], KW["watermark"], KW["safe"],
            KW["t_susp"], KW["t_surv"], *surv_plan.pack(plan), plan.scratch_words,
            _build.stream(args[0]))
        _build.check(err, "survival_scan (phases)")
        return outs

    def cycles(self, args, airlock: bool) -> list:
        """The most SM cycles any CTA spent in each phase of one call."""
        self.call(args, airlock)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (16 * 8))()
        _build.check(self.lib.survival_scan_phases(buf), "survival_scan_phases")
        stamps = np.array(list(buf), dtype=np.int64).reshape(16, 8)
        return [int(x) for x in np.diff(stamps, axis=1).max(axis=0)]


def port_call(args, airlock: bool):
    kw = dict(KW, airlock=airlock)
    plan = surv_plan.for_call(*args, **kw)
    outs = plan.new_outputs(args[0].device)
    surv_ops.launch(plan, outs, *args, **kw)
    return outs


TICK_CELLS = {  # label: (config, first recorded tick)
    "Exp5 kernel-OOM": (lambda: profile_tick.exp5_config(False), profile_tick.WARMUP_TICKS),
    "Exp5 Airlock": (lambda: profile_tick.exp5_config(True), profile_tick.WARMUP_TICKS),
    "Exp7": (profile_tick.exp7_config, profile_tick.EXP7_TICKS - 20),
}


def rounds_bench(dev, parent_path: Path | None = None) -> list:
    """``bitmap_fit_rounds`` rows of ``--rounds`` (see the module docstring)."""
    from repro_torch.kernels.bitmap_fit import bitmap_fit_rounds_ref
    from repro_torch.kernels.bitmap_fit import ops as fit_ops
    from repro_torch.kernels.bitmap_fit import plan as fit_plan

    _build.build(["bitmap_fit"])
    libs = {"port": None}
    if parent_path is not None:
        libs["parent"] = build_lib(parent_path, "parent_rounds")
        libs["parent"].bitmap_fit_rounds_launch.argtypes = fit_ops._SIG["bitmap_fit_rounds_launch"]
    order = ["parent", "port", "port", "parent"] if parent_path is not None else ["port"]
    rows = []
    for label, (make_cfg, first) in TICK_CELLS.items():
        cfg = make_cfg()
        calls = profile_tick.tick_rounds(cfg, first, 20, device=dev)
        traffic = profile_tick.rounds_traffic(calls)
        profile_tick.print_traffic(f"{label}, ticks {first} to {first + 19}", traffic)
        times = [[] for _ in order]
        for args, kw, outs in calls:
            plan = fit_plan.for_rounds_call(*args, **kw)
            got = plan.new_outputs(dev)
            for name, lib in libs.items():
                fit_ops.launch_rounds(plan, got, *args, **kw, lib=lib)
                if not all(torch.equal(g, w) for g, w in zip(got, outs)):
                    print(f"{label}: {name} differs from the tick's outputs", file=sys.stderr)
                    raise SystemExit(1)
            for i, name in enumerate(order):
                times[i].append(graph_ms(
                    lambda: fit_ops.launch_rounds(plan, got, *args, **kw, lib=libs[name])))
        args, kw, _ = calls[-1]
        row = dict(cell=label, N=cfg.num_nodes, P=cfg.probe_capacity, traffic=traffic,
                   graph_ms=[(name, float(np.median(t))) for name, t in zip(order, times)],
                   plain_ms=graph_ms(lambda: bitmap_fit_rounds_ref(*args, **kw)))
        rows.append(row)
        print(f"{label} N={cfg.num_nodes} P={cfg.probe_capacity}: graph-replay device ms of one "
              f"call, median over the 20 ticks, in order: "
              + ", ".join(f"{n} {t:.6f}" for n, t in row["graph_ms"])
              + f"; plain version {row['plain_ms']:.6f} (last tick)", flush=True)
    return rows


SHARDED_CELLS = {  # label: (config, first recorded tick)
    "Exp5 kernel-OOM": (lambda: profile_tick.exp5_config(False), profile_tick.WARMUP_TICKS),
    "Exp5 Airlock": (lambda: profile_tick.exp5_config(True), profile_tick.WARMUP_TICKS),
    "Exp6 storm kernel-OOM": (lambda: storm_config(False), profile_tick.WARMUP_TICKS),
    "Exp6 storm Airlock": (lambda: storm_config(True), profile_tick.WARMUP_TICKS),
}


def storm_config(airlock: bool):
    """Exp6's storm at its full geometry (``bench_exp6_scenarios.py``: the
    Exp5 geometry, mmpp arrivals, correlated node failures), 2400 ticks."""
    import dataclasses

    from repro_torch.workloads import SCENARIOS

    return dataclasses.replace(profile_tick.exp5_config(airlock, ticks=2400),
                               scenario=SCENARIOS["storm"])


def rounds_blocked_bench(dev) -> list:
    """``bitmap_fit_rounds_blocked`` rows of ``--rounds --sharded`` (see the
    module docstring); needs an initialized one-rank process group."""
    from repro_torch.kernels.bitmap_fit import bitmap_fit_rounds_blocked_ref
    from repro_torch.kernels.bitmap_fit import ops as fit_ops
    from repro_torch.kernels.bitmap_fit import plan as fit_plan

    _build.build(["bitmap_fit"])
    entry = "bitmap_fit_rounds_blocked"
    rows = []
    for label, (make_cfg, first) in SHARDED_CELLS.items():
        cfg = make_cfg()
        calls = profile_tick.tick_calls(cfg, first, 20, (entry,), device=dev, sharded=True)[entry]
        traffic = profile_tick.rounds_traffic(calls)
        profile_tick.print_traffic(f"{label}, sharded, ticks {first} to {first + 19}", traffic)
        times = []
        for args, kw, outs in calls:
            plan = fit_plan.for_rounds_blocked_call(*args, **kw)
            got = plan.new_outputs(dev)
            fit_ops.launch_rounds_blocked(plan, got, *args, **kw)
            if not all(torch.equal(g, w) for g, w in zip(got, outs)):
                print(f"{label}: the kernel differs from the tick's outputs", file=sys.stderr)
                raise SystemExit(1)
            times.append(graph_ms(lambda: fit_ops.launch_rounds_blocked(plan, got, *args, **kw)))
        args, kw, _ = calls[-1]
        Zb, M = args[7].shape
        row = dict(cell=label, N=cfg.num_nodes, P=cfg.probe_capacity, block=[Zb, M],
                   traffic=traffic, graph_ms=float(np.median(times)),
                   plain_ms=graph_ms(lambda: bitmap_fit_rounds_blocked_ref(*args, **kw)))
        rows.append(row)
        print(f"{label} N={cfg.num_nodes} P={cfg.probe_capacity} block {Zb} x {M}: graph-replay "
              f"device ms of one call, median over the 20 ticks {row['graph_ms']:.6f}; plain "
              f"version {row['plain_ms']:.6f} (last tick)", flush=True)
    return rows


def address_traffic(args, kw) -> dict:
    """What one ``utility_topk_address`` call was given: addressing slots,
    the warps (32 slots) holding one, and the sampled candidates whose
    report is older than ``degrade_after_ms`` (the kernel degrades only
    those)."""
    from repro_torch.core.state import ADDRESSING

    st, rep_t, t = args[0], args[16], args[22]
    active = st == ADDRESSING
    P = st.shape[0]
    warps = torch.nn.functional.pad(active, (0, -P % 32)).reshape(-1, 32).any(1)
    cand = address_view(*args, **kw)[1][active][:, 1:]
    age = (t - rep_t[cand]).float() * kw["dt_ms"]
    return dict(slots=P, addressing=int(active.sum()), warps=int(warps.numel()),
                warps_addressing=int(warps.sum()), candidates=int(cand.numel()),
                stale=int((age > kw["degrade_after_ms"]).sum()))


def tile_bench(dev, libs: dict) -> dict:
    """The tile entry ``utility_topk`` of each library at the Exp5 shape
    (P = 65 536, K = 8) on the seeded tiles of ``chip_smoke.py`` phase 2
    (half the candidates infeasible): graph-replay device ms of one call,
    in the order parent, port, port, parent (port alone without a parent);
    both checked equal to the plain version first."""
    from repro_torch.kernels.utility_topk import plan as topk_plan
    from repro_torch.kernels.utility_topk import utility_topk_ref

    rng = np.random.default_rng(2)
    P, K = 65536, 8
    tiles = tuple(torch.from_numpy(a) for a in (
        rng.uniform(0, 64, (P, K)).astype(np.float32),
        rng.uniform(0, 32, (P, K)).astype(np.float32),
        rng.normal(0, 0.5, (P, K)).astype(np.float32), rng.uniform(size=(P, K)) < 0.7))
    want = utility_topk_ref(*tiles, 1.0)
    args = tuple(a.to(dev) for a in tiles)
    plan = topk_plan.for_call(*args, 1.0)
    (L,) = plan.launches
    best, val = plan.new_outputs(dev)

    def call(lib):
        err = lib.utility_topk_launch(*(_build.ptr(a) for a in args), 1.0, _build.ptr(best),
                                      _build.ptr(val), P, K, L.grid, L.block,
                                      _build.stream(best))
        _build.check(err, "utility_topk")

    for name, lib in libs.items():
        call(lib)
        torch.cuda.synchronize()
        if not (torch.equal(best.cpu(), want[0])
                and torch.allclose(val.cpu(), want[1], rtol=1e-5, atol=1e-5)):
            print(f"tile utility_topk: {name} differs from the plain version", file=sys.stderr)
            raise SystemExit(1)
    order = ["parent", "port", "port", "parent"] if "parent" in libs else ["port"]
    row = dict(cell="tile utility_topk, P=65536, K=8",
               graph_ms=[(n, graph_ms(lambda: call(libs[n]))) for n in order])
    print(f"tile utility_topk P={P} K={K}: graph-replay device ms of one call, in order: "
          + ", ".join(f"{n} {t:.6f}" for n, t in row["graph_ms"]), flush=True)
    return row


def address_bench(dev, parent_path: Path | None = None) -> list:
    """``utility_topk_address`` and ``zone_aggregate_members`` rows of
    ``--address`` (see the module docstring)."""
    from repro_torch.kernels.utility_topk import ops as topk_ops
    from repro_torch.kernels.utility_topk import plan as topk_plan
    from repro_torch.kernels.utility_topk import utility_topk_address_ref
    from repro_torch.kernels.zone_aggregate import zone_aggregate_members

    _build.build(["utility_topk", "zone_aggregate"])
    libs = {"port": None}
    tiles = {"port": _build.load("utility_topk", topk_ops._SIG)}
    if parent_path is not None:
        parent = build_lib(parent_path, "parent_address")
        for fn, argtypes in topk_ops._SIG.items():
            if hasattr(parent, fn):  # an older source may lack an entry
                getattr(parent, fn).argtypes = argtypes
        if hasattr(parent, "utility_topk_address_launch"):
            libs["parent"] = parent
        tiles["parent"] = parent
    rows = [tile_bench(dev, tiles)]
    order = ["parent", "port", "port", "parent"] if "parent" in libs else ["port"]
    entries = ("utility_topk_address", "zone_aggregate_members")
    for label, (make_cfg, first) in TICK_CELLS.items():
        cfg = make_cfg()
        calls = profile_tick.tick_calls(cfg, first, 20, entries, device=dev)
        traffic = [address_traffic(a, k) for a, k, _ in calls["utility_topk_address"]]
        mean = {k: float(np.mean([t[k] for t in traffic])) for k in traffic[0]}
        print(f"address traffic [{label}, ticks {first} to {first + 19}], a tick: "
              f"{mean['addressing']:.1f} of {mean['slots']:.0f} slots addressing, in "
              f"{mean['warps_addressing']:.1f} of {mean['warps']:.0f} warps; "
              f"{mean['stale']:.1f} of {mean['candidates']:.0f} sampled candidates degraded",
              flush=True)
        times = [[] for _ in order]
        for args, kw, outs in calls["utility_topk_address"]:
            plan = topk_plan.for_address_call(*args, **kw)
            got = plan.new_outputs(dev)
            for name, lib in libs.items():
                topk_ops.launch_address(plan, got, *args, **kw, lib=lib)
                if not all(torch.equal(g, w) for g, w in zip(got, outs)):
                    print(f"{label}: {name} differs from the tick's outputs", file=sys.stderr)
                    raise SystemExit(1)
            for i, name in enumerate(order):
                times[i].append(graph_ms(
                    lambda: topk_ops.launch_address(plan, got, *args, **kw, lib=libs[name])))
        refresh = [graph_ms(lambda: zone_aggregate_members(*a, **k))
                   for a, k, _ in calls["zone_aggregate_members"]]
        due = [int(a[4]) % k["every"] == 0 for a, k, _ in calls["zone_aggregate_members"]]
        args, kw, _ = calls["utility_topk_address"][-1]
        row = dict(cell=label, N=cfg.num_nodes, P=cfg.probe_capacity, traffic=mean,
                   graph_ms=[(name, float(np.median(t))) for name, t in zip(order, times)],
                   plain_ms=graph_ms(lambda: utility_topk_address_ref(*args, **kw)),
                   refresh_ms={"due": float(np.median([t for t, d in zip(refresh, due) if d]))
                               if any(due) else None,
                               "not due": float(np.median([t for t, d in zip(refresh, due)
                                                           if not d]))})
        rows.append(row)
        print(f"{label} N={cfg.num_nodes} P={cfg.probe_capacity}: utility_topk_address "
              f"graph-replay device ms of one call, median over the 20 ticks, in order: "
              + ", ".join(f"{n} {t:.6f}" for n, t in row["graph_ms"])
              + f"; plain version {row['plain_ms']:.6f} (last tick); zone_aggregate_members "
              f"{row['refresh_ms']}", flush=True)
    return rows


def batch_bench(dev, B: int, parent_dir: Path | None = None) -> list:
    """The rows of ``--batch B`` (see the module docstring)."""
    import importlib

    from repro_torch.kernels import ENTRIES, LOCKSTEP

    cfg = profile_tick.exp5_config(True)
    calls = profile_tick.batch_tick_calls(cfg, list(range(B)), profile_tick.WARMUP_TICKS, 1,
                                          LOCKSTEP, device=dev)
    rows = []
    for entry in LOCKSTEP:
        e, source = ENTRIES[entry], ENTRIES[entry].source
        ((args, kw, outs),) = calls[entry]
        per = profile_tick.per_seed_calls(calls[entry])
        libs = {"port": None}
        if parent_dir is not None:
            libs["parent"] = lib = build_lib(parent_dir / f"{source}.cu", f"parent_{source}")
            sig = importlib.import_module(e.wrapper.__module__)._SIG
            for fn in sig:
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = sig[fn]
                    getattr(lib, fn).restype = ctypes.c_int

        def unbatched(lib):
            def run():
                got = []
                for a, k, _ in per:
                    plan = e.plan(*a, **k)
                    o = plan.new_outputs(dev)
                    e.launch(plan, o, *a, **k, lib=lib)
                    got.append(o)
                return got
            return run

        for label, lib in libs.items():  # each build's B launches equal the batched launch
            for i, got in enumerate(unbatched(lib)()):
                check = all(torch.equal(g, o[i]) for g, o in zip(got, outs))
                if not check:
                    print(f"batch B={B} [{entry}]: seed {i}: the {label} build's launch "
                          "without a seed axis differs from the one with it")
                    return []
        order = ["parent", "port", "port", "parent"] if parent_dir is not None else ["port"]
        times = [(label, graph_ms(unbatched(libs[label]))) for label in order]
        batched_ms = graph_ms(lambda: e.wrapper(*args, **kw))
        rows.append(dict(entry=entry, seeds=B, tick=profile_tick.WARMUP_TICKS,
                         batched_ms=batched_ms, unbatched_ms=times))
        print(f"batch B={B} [{entry}]: one launch with the seed axis {batched_ms:.6f} ms "
              f"(device, graph replay); {B} launches without, in order: "
              + ", ".join(f"{label} {t:.6f}" for label, t in times)
              + " ms; outputs equal seed by seed", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="with --rounds: another bitmap_fit.cu; with --address: another "
                         "utility_topk.cu; with --batch: a directory of another tree's sources")
    ap.add_argument("--rounds", action="store_true", help="bitmap_fit_rounds instead")
    ap.add_argument("--sharded", action="store_true",
                    help="with --rounds: bitmap_fit_rounds_blocked on the sharded tick's inputs")
    ap.add_argument("--address", action="store_true",
                    help="utility_topk_address and zone_aggregate_members instead")
    ap.add_argument("--phases", action="store_true",
                    help="cycles by phase of the cluster kernel (an instrumented build)")
    ap.add_argument("--batch", type=int, default=0, metavar="B",
                    help="the lockstep tick's five entries at B seeds")
    ap.add_argument("--out", type=Path, default=Path("build/kernel_bench.json"))
    args = ap.parse_args(argv)
    if args.parent is not None and not (args.rounds or args.address or args.batch):
        ap.error("--parent goes with --rounds, --address or --batch")
    if not torch.cuda.is_available():
        print("kernel_bench: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable"
    if args.rounds and args.sharded:
        if args.parent is not None:
            ap.error("--sharded times the port's blocked rounds alone (no --parent)")
        import os
        import tempfile

        import torch.distributed as dist

        torch.cuda.set_device(dev)
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                    rank=0, world_size=1)
            try:
                return write(args.out, card, rounds_blocked_bench(dev))
            finally:
                dist.destroy_process_group()
    if args.batch:
        rows = batch_bench(dev, args.batch, args.parent)
        return write(args.out, card, rows) if rows else 1
    if args.rounds:
        return write(args.out, card, rounds_bench(dev, args.parent))
    if args.address:
        return write(args.out, card, address_bench(dev, args.parent))
    _build.build(["survival_scan"])
    phases = Phases() if args.phases else None
    rows = []
    for seed, (label, (N, P)) in enumerate(GEOMETRIES.items(), start=2):
        a = inputs(N, P, seed, dev)
        for airlock in (True, False):
            tag = f"{label} N={N} P={P} {'airlock' if airlock else 'kernel-oom'}"
            row = dict(geometry=label, N=N, P=P, airlock=airlock)
            row["port_kernels_ms"] = k = per_kernel_ms(lambda: port_call(a, airlock))
            print(f"{tag}: port per-kernel device ms per call (profiler, eager): "
                  + ", ".join(f"{kk} {v:.6f}" for kk, v in k.items())
                  + f"; sum {sum(k.values()):.6f}")
            row["graph_ms"] = times = [("port", graph_ms(lambda: port_call(a, airlock)))]
            print(f"{tag}: graph-replay device ms per call: port {times[0][1]:.6f}")
            if phases is not None:
                row["phase_cycles"] = c = dict(zip(PHASES, phases.cycles(a, airlock)))
                row["phases_build_ms"] = graph_ms(lambda: phases.call(a, airlock))
                print(f"{tag}: SM cycles by phase (most over the CTAs; instrumented build, "
                      f"{row['phases_build_ms']:.6f} ms a call): "
                      + ", ".join(f"{k} {v}" for k, v in c.items()) + f"; sum {sum(c.values())}")
            rows.append(row)
    return write(args.out, card, rows)


def write(out: Path, card: str, rows: list) -> int:
    print(card)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "torch": torch.__version__,
                               "cuda": torch.version.cuda, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
