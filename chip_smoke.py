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
     phase 5 (65 536 nodes / 131 072 slots, blocked at 253 x 307), there
     ``bitmap_fit_rounds``, ``utility_topk_address`` (the DA addressing
     step in one launch) and ``zone_aggregate_members`` (the TEG refresh in
     one launch; also without its select, as the sharded tick calls it) on
     the inputs the flat engine's own tick gives them (Exp5's tick 200,
     Exp7's tick 99; what they hold is printed), and
     ``bitmap_fit_rounds_blocked`` (the zone-sharded tick's rounds in one
     launch on the rank's zone block) on the inputs the zone-sharded
     engine's own tick gives it at the same ticks; time kernel and plain
     version on the card at each, ``bitmap_fit_rounds`` against the
     one-round ``bitmap_fit`` launches it replaces and
     ``bitmap_fit_rounds_blocked`` against the one-round
     ``bitmap_fit_blocked`` launches it replaces;
     ``survival_scan`` also at its corners
     (``repro_torch.kernel_bench.edge_cases``: signed-zero score ties, +-inf
     scores, one node with a fifth of the slots, an empty table, every slot
     on one node, Exp7's shape), Airlock on and off, bit-equal;
     ``bitmap_fit_rounds`` at its own (``rounds_edge_cases``: E_v ties,
     +-inf, signed-zero and NaN E_v, throttled nodes, fewer queued probes
     than rounds, demands of 0 and past the atoms, 48 atoms and 3 or 8 words
     a node, both policies, every probe queued at Exp7's shape), bit-equal,
     the NaN case also to the plain version on the card;
     ``bitmap_fit_rounds_blocked`` at the same corners on jittered zones
     (``rounds_blocked_edge_cases``: one rank's block and each of two
     ranks', and node 0's probes beside padding slots), bit-equal, NaN
     also on the card;
     ``utility_topk_address`` at its own (``address_edge_cases``: no slot
     and every slot addressing, every candidate infeasible, score ties,
     node -1, empty zones, migrating probes that Fast-Fail, bounces into
     another zone, stale reports, no projection, K = 5), every output
     bit-equal on every input, a mismatched slot printed with its score
     gap;
  2b. every launch under its checked plan: each kernel's compiled attributes
     (``<name>_attrs``: static shared memory, registers, maxThreadsPerBlock)
     against every plan of phase 2's shapes (static shared memory as
     declared, within the H100's per-block budget and register file);
     ``survival_scan``'s, ``bitmap_fit_rounds``' and
     ``bitmap_fit_rounds_blocked``'s one cluster a call: the source's
     dynamic shared memory and scratch words equal the plan's, and
     the card takes the cluster (``cudaOccupancyMaxActiveClusters`` >= 1,
     the non-portable attribute set past 8 CTAs); each entry launched
     through the wrapper's own launch function and plan into outputs that
     sit in sentinel-filled buffers with guard bands, at the ragged, Exp5
     and Exp7 shapes: no sentinel left inside (LC301 on the card), bands
     untouched (LC302), equal to the plain version; ``block_copy`` (the
     port of the analyzer's fixture kernels) under the good plan and the
     three bad plans of ``tests/fixtures/torch_analysis/bad_launch_tail.py``:
     one device kernel a call (one kernel node of a captured CUDA graph,
     ``kernel_bench.graph_nodes``), its NaN tail its own,
     against the plan interpreter, timed beside ``Tensor.clone``;
  3. run the flat engine on the card at the Exp5 geometry (5000 nodes,
     65 536 probe slots, memory dynamics on), Airlock off then on, 800
     ticks each; check the launch counts (one ``bitmap_fit_rounds``, one
     ``utility_topk_address`` and one ``zone_aggregate_members`` a tick; no
     one-round ``bitmap_fit`` and no tile ``utility_topk`` or
     ``zone_aggregate``), the task-conservation identity and the host
     syncs;
  4. run 64-node configs on the CPU (plain versions) and on the card
     (kernels) with the same draws and compare every integer metric and the
     per-tick timeseries: Exp5 Airlock off and on, the six scenario presets
     with Airlock on, and storm through the zone-sharded engine;
  5. Exp7's top cell (65 536 nodes, 131 072 slots, 100 ticks): the flat
     engine and the zone-sharded engine with the same draws; ticks/s, the
     traffic model, equal outputs; on the sharded run one
     ``bitmap_fit_rounds_blocked`` a tick, no one-round
     ``bitmap_fit_blocked``, and five ``all_gather`` calls a tick (none on
     the flat run);
  6. the storm scenario at Exp6's full geometry (5000 nodes, 65 536 slots,
     memory on) through the zone-sharded engine, Airlock off then on: node
     failures, kills only without Airlock, task conservation, the launches
     and ``all_gather`` calls of phase 5's sharded run;
  7. print the kernel table as JSON, the card's name and power limit, and
     last the result line.

Every launch counter is set to 0 just before each run of phases 3, 5 and 6
and read just after; the table's ``launches`` sums those runs (0 for the
three fixture rows, whose ``smoke_launches`` counts phase 2b's own).
"""

from __future__ import annotations

import ctypes
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
EXP7_TICKS = 100  # bench_exp7_scale.py NUM_TICKS
STORM_TICKS = 2400
REPLACES = {
    "bitmap_fit": "src/repro/kernels/bitmap_fit/kernel.py:117",
    "bitmap_fit_rounds": "src/repro/kernels/bitmap_fit/kernel.py:117",  # redesigned
    "bitmap_fit_blocked": "src/repro/kernels/bitmap_fit/ops.py:40",
    "bitmap_fit_rounds_blocked": "src/repro/kernels/bitmap_fit/ops.py:40",  # redesigned
    "utility_topk": "src/repro/kernels/utility_topk/kernel.py:67",
    "utility_topk_address": "src/repro/kernels/utility_topk/kernel.py:67",  # redesigned
    "zone_aggregate": "src/repro/kernels/zone_aggregate/kernel.py:47",
    "zone_aggregate_members": "src/repro/kernels/zone_aggregate/kernel.py:47",  # redesigned
    "survival_scan": "src/repro/kernels/survival_scan/kernel.py:241",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["bitmap_fit_blocked"] = "src/repro_torch/csrc/bitmap_fit.cu"  # same kernel
SOURCES["bitmap_fit_rounds"] = "src/repro_torch/csrc/bitmap_fit.cu"  # same source
SOURCES["bitmap_fit_rounds_blocked"] = "src/repro_torch/csrc/bitmap_fit.cu"  # same body
SOURCES["utility_topk_address"] = "src/repro_torch/csrc/utility_topk.cu"  # same source
SOURCES["zone_aggregate_members"] = "src/repro_torch/csrc/zone_aggregate.cu"  # same kernel
# the entries whose outputs must equal the plain version's bit for bit, the
# floats included (the others' float outputs: rtol 1e-5)
EXACT = ("survival_scan", "utility_topk_address")


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


def members_case(member, mask, seed, t=None, every=20):
    """zone_aggregate_members inputs on a zone geometry ((Z, M) members and
    validity): reported slack and heat of the nodes, and with ``t`` the old
    table for the refresh select; bytes and operations None (from the data)."""
    rng = np.random.default_rng(seed)
    Z = member.shape[0]
    N = int(member.max()) + 1

    def f(n):
        return torch.from_numpy(rng.uniform(0, 64, n).astype(np.float32))

    args = (f(N), f(N), torch.from_numpy(member), torch.from_numpy(mask))
    if t is not None:
        args += (torch.tensor(t, dtype=torch.int32), f(Z), f(Z))
    return args, dict(every=every), None, None


def members_work(args, kw):
    """(bytes, operations) of zone_aggregate_members on these inputs: on a
    refresh tick (or without the select) the member index and mask of every
    slot, S and H of each distinct member, the tick, the table out; off a
    refresh tick the tick, the old table and the table out."""
    member = args[2]
    Z, M = member.shape
    if len(args) > 4 and int(args[4]) % kw["every"] != 0:
        return 4 + 16 * Z, Z
    return (8 * Z * M + 8 * int(member.unique().numel()) + 8 * Z + (4 if len(args) > 4 else 0),
            6 * Z * M)


def address_work(args, kw, want):
    """(bytes, operations) of utility_topk_address on these inputs: st,
    node, zone, timer and patience of every slot read once and the five
    written; of each addressing slot also migrating, mass, contig and its
    2K - 1 draws; the zone start and count of each distinct zone addressed
    from; the reported view (with derivatives when projecting) of each
    distinct sampled candidate, the true view of each distinct launchpad,
    the zone id of each distinct bounce target; the tick and the counts.
    About forty operations a candidate."""
    from repro_torch.core.state import ADDRESSING, BOUNCING
    from repro_torch.kernels.utility_topk.ref import address_view

    P, K = args[9].shape
    active = args[0] == ADDRESSING
    A = int(active.sum())
    here, cand = address_view(*args, **kw)[:2]
    bounced = active & (want[0] == BOUNCING)
    per_node = 24 if kw["projection"] else 16
    nbytes = (40 * P + A * (6 + 4 * (2 * K - 1)) + 8 * int(args[2][active].unique().numel())
              + per_node * int(cand[active][:, 1:].unique().numel())
              + 12 * int(here[active].unique().numel())
              + 4 * int(want[1][bounced].unique().numel()) + 4 + 12)
    return nbytes, 40 * A * K + 4 * P


def address_mismatches(args, kw, got, want, limit=8):
    """Print the slots whose outputs differ from the plain version's, each
    with its score gap: the best score less the runner-up's, and the best
    less the launchpad's score plus the margin (a near-tie shows as a gap
    of an ulp or so)."""
    from repro_torch.kernels.utility_topk.ref import address_view, utility_topk_ref

    bad = torch.zeros(args[0].shape[0], dtype=torch.bool)
    for g, w in zip(got[:5], want[:5]):
        bad |= g != w
    rows = bad.nonzero().flatten()[:limit]
    if not len(rows):
        return
    here, cand, s_eff, h_eff, feas, eps = address_view(*args, **kw)
    best, val = utility_topk_ref(s_eff, h_eff, eps, feas, kw["gamma"])
    score = torch.where(feas, torch.log2(1.0 + s_eff.clamp(min=0))
                        - kw["gamma"] * torch.log2(1.0 + h_eff.clamp(min=0)) + eps, -3.0e38)
    top2 = score.topk(2, dim=1).values if score.shape[1] > 1 else score.repeat(1, 2)
    for i in rows.tolist():
        print(f"  slot {i}: kernel (st, node, zone, timer, patience) "
              f"{[float(g[i]) for g in got[:5]]}, plain {[float(w[i]) for w in want[:5]]}; "
              f"best {int(best[i])} score {float(val[i])!r}, gap to the runner-up "
              f"{float(top2[i, 0] - top2[i, 1])!r}, gap to the launchpad + margin "
              f"{float(val[i] - (score[i, 0] + kw['stay_margin']))!r}")


def rounds_work(args, kw, want):
    """(bytes, operations) ``bitmap_fit_rounds`` must move and do on these
    inputs, from the plain version's outputs: st of every slot; node, ev and
    the node's throttled flag of each queued slot; mass and contig of each
    winner; the words of each node with a winner; every output once. About
    ten integer operations a slot or cascade step, a few hundred a winner."""
    from repro_torch.core.state import QUEUED

    st = args[0]
    N, W = args[5].shape
    R = kw["rounds"]
    winner = want[0]
    queued = int((st == QUEUED).sum())
    wins = int((winner >= 0).sum())
    live = int((winner >= 0).any(0).sum()) if R else 0
    out_bytes = R * N * (4 + 1 + 4 * W) + st.shape[0] * 5
    nbytes = 4 * st.shape[0] + 9 * queued + 5 * wins + 4 * W * live + out_bytes
    return nbytes, 10 * (st.shape[0] + queued * R) + 400 * wins


def rounds_blocked_work(args, kw, want):
    """(bytes, operations) ``bitmap_fit_rounds_blocked`` must move and do on
    these inputs: st of every slot; node, ev, and the node's throttled flag
    and slot in the block (local) of each queued slot; mass and contig of
    each winner; member, mask and the words of each block slot with a
    winner; every output once. Operations as for bitmap_fit_rounds."""
    from repro_torch.core.state import QUEUED

    st, node = args[0], args[1]
    N, W = args[5].shape
    R, n = kw["rounds"], args[7].numel()
    winner = want[0].reshape(R, n)
    queued = int(((st == QUEUED) & (node >= 0) & (node < N)).sum())
    wins = int((winner >= 0).sum())
    live = int((winner >= 0).any(0).sum()) if R else 0
    out_bytes = R * n * (4 + 1 + 4 * W)
    nbytes = 4 * st.shape[0] + 13 * queued + 5 * wins + (8 + 4 * W) * live + out_bytes
    return nbytes, 10 * (st.shape[0] + queued * R) + 400 * wins


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


def work(name, case, want):
    """(bytes, operations) a kernel entry must move and do on a case: from
    the case where its shapes fix them, else from the data."""
    if case[2] is not None:
        return case[2:4]
    if name == "bitmap_fit_rounds":
        return rounds_work(case[0], case[1], want)
    if name == "bitmap_fit_rounds_blocked":
        return rounds_blocked_work(case[0], case[1], want)
    if name == "utility_topk_address":
        return address_work(case[0], case[1], want)
    return members_work(case[0], case[1])


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


def compare(name, got, want):
    """Hold kernel outputs (CPU copies) to the plain version's; returns the
    max abs error of the float outputs."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name} output {i}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if w.dtype.is_floating_point:
            e = float((g - w).abs().max()) if w.numel() else 0.0
            err = max(err, e)
            # survival_scan's pressure is summed in slot order on both sides
            # and utility_topk_address's patience is plain arithmetic: exact;
            # utility_topk (log2f vs the CPU log2) and zone_aggregate(_members)
            # (summation order) are held to rtol 1e-5
            tol = 0.0 if name in EXACT else 1e-5
            check(torch.allclose(g, w, rtol=tol, atol=tol),
                  f"{name} output {i}: max abs err {e} beyond rtol {tol}")
        else:
            check(torch.equal(g, w), f"{name} output {i}: "
                  f"{int((g != w).sum())} of {w.numel()} entries differ")
    return err


def check_kernel(name, wrapper, ref, case, dev):
    """The wrapper on the card against its plain version on CPU copies;
    returns (max abs err, the plain version's outputs). A mismatched slot of
    utility_topk_address is printed with its score gap."""
    args, kw = case[0], case[1]
    got = [g.cpu() for g in as_tuple(wrapper(*to_dev(args, dev), **kw))]  # waits
    want = as_tuple(ref(*args, **kw))
    if name == "utility_topk_address":
        address_mismatches(args, kw, got, want)
    return compare(name, got, want), want


def phase2(dev, geometries):
    """Each kernel entry against its plain version at a ragged shape, then at
    every main-path geometry (``geometries``: label -> (kernel_cases kwargs,
    (zone members, zone mask), (config, tick))); ``bitmap_fit_rounds`` there
    on the inputs the flat engine's tick ``tick`` of a run of that config
    gives it, ``bitmap_fit_rounds_blocked`` on those the zone-sharded
    engine's tick ``tick`` gives it. The table's row of a kernel is timed at
    the first geometry, the one of the most launches (phases 3 and 6)."""
    from repro_torch.core.state import densify_zones
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.bitmap_fit import (
        bitmap_fit_blocked_ref,
        bitmap_fit_ref,
        bitmap_fit_rounds_blocked_ref,
        bitmap_fit_rounds_ref,
    )
    from repro_torch.kernels.survival_scan import survival_scan_ref
    from repro_torch.kernel_bench import address_edge_cases, address_inputs, address_kw
    from repro_torch.kernels.utility_topk import utility_topk_address_ref, utility_topk_ref
    from repro_torch.kernels.zone_aggregate import zone_aggregate_members_ref, zone_aggregate_ref

    refs = {"bitmap_fit": bitmap_fit_ref, "bitmap_fit_blocked": bitmap_fit_blocked_ref,
            "bitmap_fit_rounds": bitmap_fit_rounds_ref,
            "bitmap_fit_rounds_blocked": bitmap_fit_rounds_blocked_ref,
            "utility_topk": utility_topk_ref,
            "utility_topk_address": utility_topk_address_ref,
            "zone_aggregate": zone_aggregate_ref,
            "zone_aggregate_members": zone_aggregate_members_ref,
            "survival_scan": survival_scan_ref}
    # ragged small shape first: tails that are no multiple of a block
    ragged = kernel_cases(N=37, P=1029, K=8, Z=3, M=13, W=2, seed=1)
    member, mask = densify_zones(np.array([0, 13, 20], np.int32), np.array([13, 7, 10], np.int32))
    ragged["bitmap_fit_blocked"] = blocked_case(member, mask, W=2, seed=1)
    from repro_torch.kernel_bench import blocked_split, jittered_counts, rounds_inputs

    # bytes and operations of bitmap_fit_rounds follow from the data: None
    ragged["bitmap_fit_rounds"] = (*rounds_inputs(37, 1029, 2, seed=1), None, None)
    ragged["bitmap_fit_rounds_blocked"] = (
        *blocked_split(*rounds_inputs(37, 1029, 2, seed=1), jittered_counts(37, 13, seed=1),
                       rank=1, ranks=2), None, None)
    ragged["utility_topk_address"] = (address_inputs(37, 1029, 8, 3, seed=1, addressing=0.3),
                                      address_kw(), None, None)
    ragged["zone_aggregate_members"] = members_case(member, mask, seed=1, t=40)
    checked = {"ragged": {}}
    for name, case in ragged.items():
        checked["ragged"][name] = (case, check_kernel(name, WRAPPERS[name], refs[name], case, dev)[1])
    print("phase 2: ragged shapes (N=37, P=1029, Z=3, M=13; blocked Z=3, M=13 with "
          "zeroed padding slots; the blocked rounds on the second of two ranks' zone rows "
          "of up to 13 nodes) equal to the plain versions")
    # survival_scan's corners: signed-zero ties, +-inf scores, skewed and
    # empty tables, Exp7's shape; Airlock on and off, bit-equal
    from repro_torch.kernel_bench import edge_cases

    for cname, args in edge_cases().items():
        for airlock in (True, False):
            kw = dict(airlock=airlock, residual=0.3, watermark=0.9 if airlock else 1.0, safe=0.8,
                      t_susp=80, t_surv=240)
            case = (args, kw, 0, 0)
            want = check_kernel("survival_scan", WRAPPERS["survival_scan"], survival_scan_ref,
                                case, dev)[1]
            checked[f"{cname}, airlock {'on' if airlock else 'off'}"] = {
                "survival_scan": (case, want)}
    print(f"phase 2: survival_scan edge cases ({', '.join(edge_cases())}), Airlock on and off: "
          "bit-equal to the plain version")
    # bitmap_fit_rounds' corners: E_v ties, +-inf / signed-zero / NaN E_v,
    # throttled nodes, fewer queued probes than rounds, demands of 0 and past
    # the atoms, 48 atoms and 3 or 8 words a node, both policies, every probe
    # queued at Exp7's shape; bit-equal. The plain version on the card gives
    # the NaN case's answer too (its scatter-max propagates NaN, as the CPU's)
    from repro_torch.kernel_bench import rounds_edge_cases

    for cname, (args, kw) in rounds_edge_cases().items():
        case = (args, kw, 0, 0)
        want = check_kernel("bitmap_fit_rounds", WRAPPERS["bitmap_fit_rounds"],
                            bitmap_fit_rounds_ref, case, dev)[1]
        if cname == "nan":
            on_card = [w.cpu() for w in bitmap_fit_rounds_ref(*to_dev(args, dev), **kw)]
            compare("bitmap_fit_rounds (the plain version on the card)", on_card, want)
        checked[f"rounds {cname}"] = {"bitmap_fit_rounds": (case, want)}
    print(f"phase 2: bitmap_fit_rounds edge cases ({', '.join(rounds_edge_cases())}): bit-equal "
          "to the plain version (NaN: on the CPU and on the card)")
    # the same corners on jittered zones, as one rank's block and as each of
    # two ranks', and node 0's probes beside padding slots; bit-equal
    from repro_torch.kernel_bench import rounds_blocked_edge_cases

    blocked_corners = rounds_blocked_edge_cases()
    for cname, (args, kw) in blocked_corners.items():
        case = (args, kw, 0, 0)
        want = check_kernel("bitmap_fit_rounds_blocked", WRAPPERS["bitmap_fit_rounds_blocked"],
                            bitmap_fit_rounds_blocked_ref, case, dev)[1]
        if cname.startswith("nan"):
            on_card = [w.cpu() for w in bitmap_fit_rounds_blocked_ref(*to_dev(args, dev), **kw)]
            compare("bitmap_fit_rounds_blocked (the plain version on the card)", on_card, want)
        checked[f"blocked rounds {cname}"] = {"bitmap_fit_rounds_blocked": (case, want)}
    print(f"phase 2: bitmap_fit_rounds_blocked edge cases ({', '.join(blocked_corners)}): "
          "bit-equal to the plain version (NaN: on the CPU and on the card)")
    # utility_topk_address's corners: no slot / every slot addressing, every
    # candidate infeasible, score ties, node -1, empty zones, migrating
    # probes that Fast-Fail, bounces into another zone, stale reports, no
    # projection, K = 5; every output bit-equal
    for cname, (args, kw) in address_edge_cases().items():
        case = (args, kw, None, None)
        want = check_kernel("utility_topk_address", WRAPPERS["utility_topk_address"],
                            utility_topk_address_ref, case, dev)[1]
        checked[f"address {cname}"] = {"utility_topk_address": (case, want)}
    print(f"phase 2: utility_topk_address edge cases ({', '.join(address_edge_cases())}): "
          "bit-equal to the plain version on every output")
    rows = {}
    from repro_torch.core.state import ADDRESSING
    from repro_torch.profile_tick import print_traffic, rounds_traffic, tick_calls

    recorded = ("bitmap_fit_rounds", "utility_topk_address", "zone_aggregate_members")
    for seed, (label, (geometry, zones, (cfg, tick))) in enumerate(geometries.items(), start=2):
        cases = kernel_cases(**geometry, seed=seed)
        cases["bitmap_fit_blocked"] = blocked_case(*zones, W=geometry["W"], seed=seed)
        calls = tick_calls(cfg, tick, 1, recorded, device=dev)
        print_traffic(f"{label}, tick {tick}", rounds_traffic(calls["bitmap_fit_rounds"]))
        sharded = "bitmap_fit_rounds_blocked"
        calls.update(tick_calls(cfg, tick, 1, (sharded,), device=dev, sharded=True))
        print_traffic(f"{label}, tick {tick}, zone-sharded", rounds_traffic(calls[sharded]))
        for name in (*recorded, sharded):  # the engines' own ticks' inputs
            ((args, kw, _),) = calls[name]
            cases[name] = (tuple(a.cpu() for a in args), kw, None, None)
        args, kw = cases["utility_topk_address"][:2]
        every = cases["zone_aggregate_members"][1]["every"]
        print(f"phase 2 [{label}]: {geometry}, blocked (Z, M) = {tuple(zones[0].shape)}; "
              f"tick {tick}: {int((args[0] == ADDRESSING).sum())} of {args[0].shape[0]} slots "
              f"addressing, a refresh tick: {tick % every == 0}")
        checked[label] = {}
        times = {}
        cfg_rounds = cases["bitmap_fit_rounds"][1]["rounds"]
        for name, case in cases.items():
            err, want = check_kernel(name, WRAPPERS[name], refs[name], case, dev)
            checked[label][name] = (case, want)
            args = to_dev(case[0], dev)
            kw = case[1]
            nbytes, nops = work(name, case, want)
            ms = device_ms(lambda: WRAPPERS[name](*args, **kw))
            plain_ms = device_ms(lambda: refs[name](*args, **kw))
            eager_ms = call_ms(lambda: WRAPPERS[name](*args, **kw))
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = nops / FP32_OPS_PER_S * 1e3
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
            times[name] = ms
        print(f"phase 2 [{label}]: bitmap_fit_rounds {times['bitmap_fit_rounds']:.6f} ms a tick "
              f"against {cfg_rounds} one-round bitmap_fit launches, "
              f"{cfg_rounds * times['bitmap_fit']:.6f} ms; bitmap_fit_rounds_blocked "
              f"{times['bitmap_fit_rounds_blocked']:.6f} ms a sharded tick against "
              f"{cfg_rounds} one-round bitmap_fit_blocked launches, "
              f"{cfg_rounds * times['bitmap_fit_blocked']:.6f} ms")
        # the sharded tick's call: the rank's zone rows without the select
        case = (cases["zone_aggregate_members"][0][:4], {}, None, None)
        want = check_kernel("zone_aggregate_members", WRAPPERS["zone_aggregate_members"],
                            zone_aggregate_members_ref, case, dev)[1]
        checked[f"{label}, no select"] = {"zone_aggregate_members": (case, want)}
        print(f"phase 2 [{label}]: zone_aggregate_members without the select (the sharded "
              f"tick's call) on tick {tick}'s inputs: equal to the plain version")
    return rows, checked


# ---------------------------------------------------------------------------
# phase 2b: every launch under its checked plan, on the card
# ---------------------------------------------------------------------------

BAND = 1024  # guard-band elements on each side of an output
SENTINEL = {torch.float32: (torch.int32, 0x7FA5A5A5),  # a signalling NaN
            torch.int32: (torch.int32, -0x5A5A5A5B),  # 0xA5A5A5A5
            torch.bool: (torch.uint8, 0xA5)}
# the fixture kernels: the three pallas_calls of the JAX package's
# tests/fixtures/analysis/bad_blockspec_tail.py and their line
FIXTURE_REPLACES = {
    "tail_dropping_grid": "tests/fixtures/analysis/bad_blockspec_tail.py:29",
    "index_map_overshoot": "tests/fixtures/analysis/bad_blockspec_tail.py:44",
    "vmem_over_budget": "tests/fixtures/analysis/bad_blockspec_tail.py:59",
}
# what the analyzer says of each on the CPU, as the JAX analyzer of its pallas_call
FIXTURE_RULES = {"tail_dropping_grid": ["LC301"], "index_map_overshoot": ["LC301", "LC302"],
                 "vmem_over_budget": ["LC303"]}


def guarded(shape, dtype, dev, fill=None):
    """A view of ``shape`` inside a buffer with BAND elements on each side,
    all of it filled with ``fill`` (default: the dtype's sentinel pattern).
    Returns (view, buffer)."""
    n = int(np.prod(shape)) if len(shape) else 1
    buf = torch.empty(n + 2 * BAND, dtype=dtype, device=dev)
    if fill is None:
        as_dtype, pattern = SENTINEL[dtype]
        buf.view(as_dtype).fill_(pattern)
    else:
        buf.fill_(fill)
    return buf[BAND:BAND + n].view(shape), buf


def sentinel_hits(buf, dtype):
    """(sentinel words left inside the output, band words not sentinel)."""
    as_dtype, pattern = SENTINEL[dtype]
    hit = buf.view(as_dtype) == pattern
    inner = int((~hit[:BAND]).sum()) + int((~hit[-BAND:]).sum())
    return int(hit[BAND:-BAND].sum()), inner


def load_fixture_plans():
    """``PLANS`` of tests/fixtures/torch_analysis/bad_launch_tail.py."""
    import importlib.util

    path = ROOT / "tests" / "fixtures" / "torch_analysis" / "bad_launch_tail.py"
    spec = importlib.util.spec_from_file_location("bad_launch_tail", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PLANS


def phase2b(dev, checked):
    """Attributes against plans, guard bands around every entry's outputs,
    and the block_copy kernel under the good plan and the three bad ones.
    Returns the table rows of the three fixture kernels."""
    from repro_torch.analysis.kernel_contract import PER_BLOCK, audit_launch_plan
    from repro_torch.kernels import LAUNCHERS, PLANS, _build
    from repro_torch.kernels.bitmap_fit import ops as bitmap_ops
    from repro_torch.kernels.bitmap_fit import plan as bitmap_plan
    from repro_torch.kernels.block_copy import block_copy, block_copy_ref
    from repro_torch.kernels.block_copy import ops as copy_ops
    from repro_torch.kernels.block_copy import plan as copy_plan
    from repro_torch.kernels.survival_scan import ops as surv_ops
    from repro_torch.kernels.survival_scan import plan as surv_plan
    from repro_torch.kernels.utility_topk import plan as topk_plan
    from repro_torch.kernels.zone_aggregate import plan as agg_plan

    # -- compiled attributes against every plan ------------------------------
    attrs = {}
    for mod in (bitmap_plan, topk_plan, agg_plan, surv_plan, copy_plan):
        name = mod.__name__.split(".")[-2]  # the package, named as its source
        for k, kernel in enumerate(mod.KERNELS):
            attrs[kernel] = a = _build.attrs(name, k)
            print(f"phase 2b: {name}.cu {kernel}: {a['registers']} registers/thread, "
                  f"{a['static_smem']} B static shared memory, max {a['max_threads']} "
                  f"threads/block")
    fixture_plans = load_fixture_plans()
    plans = [PLANS[name](*case[0], **case[1])
             for per in checked.values() for name, (case, _) in per.items()]
    plans += [copy_plan.good_plan(1024, 128)] + [p for p, _ in fixture_plans.values()]
    n_launch = 0
    for plan in plans:
        hog = plan is fixture_plans["vmem_over_budget"][0]
        for L in plan.launches:
            a = attrs[L.kernel]
            n_launch += 1
            check(a["static_smem"] == L.static_smem,
                  f"{L.kernel}: compiled static shared memory {a['static_smem']} B, plan "
                  f"declares {L.static_smem} B")
            check(a["static_smem"] <= PER_BLOCK["static_smem"]
                  and (hog or a["static_smem"] + L.dynamic_smem <= PER_BLOCK["smem"]),
                  f"{L.kernel}: shared memory over the H100's per-block budget")
            check(L.block <= a["max_threads"],
                  f"{L.kernel}: block {L.block} > maxThreadsPerBlock {a['max_threads']}")
            check(a["registers"] * L.block <= 65536,
                  f"{L.kernel}: {a['registers']} registers x {L.block} threads > 65536")
    # survival_scan: one cluster a call, laid out as the source lays it out
    lib = _build.load("survival_scan", {"survival_scan_scratch_words": [ctypes.c_int] * 2,
                                        "survival_scan_smem_bytes": [ctypes.c_int] * 2})
    clusters = set()
    for per in checked.values():
        if "survival_scan" not in per:
            continue
        case = per["survival_scan"][0]
        P, N = case[0][0].shape[0], case[0][8].shape[0]
        plan = PLANS["survival_scan"](*case[0], **case[1])
        (L,) = plan.launches
        check(L.grid == L.cluster and L.cluster_nonportable == (L.cluster > 8),
              f"survival_scan at P={P}, N={N}: grid {L.grid}, cluster {L.cluster}")
        check(lib.survival_scan_scratch_words(P, N) == plan.scratch_words,
              f"survival_scan scratch words at P={P}, N={N}: plan and source disagree")
        check(lib.survival_scan_smem_bytes(N, L.cluster) == L.dynamic_smem,
              f"survival_scan shared memory at N={N}: plan and source disagree")
        occ = surv_ops.cluster_occupancy(plan)
        check(occ["clusters"] >= 1 and occ["max_dynamic_smem"] >= L.dynamic_smem
              and occ["nonportable"] == int(L.cluster_nonportable),
              f"survival_scan at N={N}: the card does not take the cluster launch: {occ}")
        clusters.add((L.cluster, L.dynamic_smem, occ["clusters"]))
    # bitmap_fit_rounds: one cluster a call, its scratch as the source's, and
    # the card takes the cluster of the instantiation for the node's words
    lib = _build.load("bitmap_fit", {"bitmap_fit_rounds_scratch_words": [ctypes.c_int] * 2})
    round_clusters = set()
    for per in checked.values():
        if "bitmap_fit_rounds" not in per:
            continue
        args, kw = per["bitmap_fit_rounds"][0][:2]
        plan = PLANS["bitmap_fit_rounds"](*args, **kw)
        (L,) = plan.launches
        N, W = args[5].shape
        check(L.grid == L.cluster and L.cluster_nonportable == (L.cluster > 8)
              and L.kernel == f"bitmap_fit_rounds_kernel<{(W + 1) // 2}>",
              f"bitmap_fit_rounds at N={N}, W={W}: {L.kernel}, grid {L.grid}, cluster {L.cluster}")
        check(lib.bitmap_fit_rounds_scratch_words(N, kw["rounds"]) == plan.scratch_words,
              f"bitmap_fit_rounds scratch words at N={N}: plan and source disagree")
        occ = bitmap_ops.rounds_cluster_occupancy(plan)
        check(occ["clusters"] >= 1 and occ["nonportable"] == int(L.cluster_nonportable),
              f"bitmap_fit_rounds at W={W}: the card does not take the cluster launch: {occ}")
        round_clusters.add((L.kernel, L.cluster, occ["clusters"]))
    for per in checked.values():
        if "bitmap_fit_rounds_blocked" not in per:
            continue
        args, kw = per["bitmap_fit_rounds_blocked"][0][:2]
        plan = PLANS["bitmap_fit_rounds_blocked"](*args, **kw)
        (L,) = plan.launches
        n, W = args[7].numel(), args[5].shape[1]
        check(L.grid == L.cluster and L.cluster_nonportable == (L.cluster > 8)
              and L.kernel == f"bitmap_fit_rounds_blocked_kernel<{(W + 1) // 2}>",
              f"bitmap_fit_rounds_blocked at {n} slots, W={W}: {L.kernel}, grid {L.grid}, "
              f"cluster {L.cluster}")
        check(lib.bitmap_fit_rounds_scratch_words(n, kw["rounds"]) == plan.scratch_words,
              f"bitmap_fit_rounds_blocked scratch words at {n} slots: plan and source disagree")
        occ = bitmap_ops.rounds_cluster_occupancy(plan)
        check(occ["clusters"] >= 1 and occ["nonportable"] == int(L.cluster_nonportable),
              f"bitmap_fit_rounds_blocked at W={W}: the card does not take the cluster launch: "
              f"{occ}")
        round_clusters.add((L.kernel, L.cluster, occ["clusters"]))
    print(f"phase 2b: {len(plans)} plans, {n_launch} launches: static shared memory as "
          f"declared, within {PER_BLOCK['static_smem']} B static / {PER_BLOCK['smem']} B "
          f"total, maxThreadsPerBlock and the register file; survival_scan, "
          f"bitmap_fit_rounds and bitmap_fit_rounds_blocked one cluster a call, shared memory "
          f"and scratch words equal the source's; survival_scan (cluster, dynamic shared "
          f"memory, clusters resident at once): {sorted(clusters)}; the rounds (kernel, "
          f"cluster, clusters resident at once): {sorted(round_clusters)}")

    # -- guard bands around every entry's outputs -----------------------------
    for label, per in checked.items():
        for name, (case, want) in per.items():
            args, kw = to_dev(case[0], dev), case[1]
            plan = PLANS[name](*args, **kw)
            views = [guarded(o.shape, o.dtype, dev) for o in plan.outputs]
            extra = {}
            if plan.scratch_words:  # survival_scan and the rounds
                scratch, sbuf = guarded((plan.scratch_words,), torch.int32, dev)
                extra["scratch"] = scratch
            LAUNCHERS[name](plan, [v for v, _ in views], *args, **kw, **extra)
            torch.cuda.synchronize()
            for (v, buf), o in zip(views, plan.outputs):
                left, touched = sentinel_hits(buf, o.dtype)
                check(left == 0, f"[{label}] {name} {o.name}: {left} elements never written "
                                 "(LC301 on the card)")
                check(touched == 0, f"[{label}] {name} {o.name}: {touched} guard-band elements "
                                    "written (LC302 on the card)")
            if plan.scratch_words:
                check(sentinel_hits(sbuf, torch.int32)[1] == 0,
                      f"[{label}] {name} wrote outside its scratch (LC302 on the card)")
            compare(name, [v.cpu() for v, _ in views], want)
        print(f"phase 2b [{label}]: every entry's outputs fully written, guard bands "
              f"untouched, equal to the plain versions")

    # -- block_copy under the good plan and the three bad ones -----------------
    rng = np.random.default_rng(13)
    n = 1024
    x, xbuf = guarded((n,), torch.float32, dev, fill=-7.5)  # poisoned guard band
    x.copy_(torch.from_numpy(rng.normal(size=n).astype(np.float32)))
    xc = x.cpu()
    block_copy.launches = 0
    good = copy_plan.good_plan(n, 128)
    got = block_copy(x, good).cpu()
    check(torch.equal(got, xc) and torch.equal(got, block_copy_ref(xc, good)),
          "block_copy under the good plan differs from its plain version")
    from repro_torch.kernel_bench import graph_nodes

    rows = {}
    for fname, plan in (("good", good), *((f, p) for f, (p, _) in fixture_plans.items())):
        nodes = graph_nodes(lambda: block_copy(x, plan))
        check(nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0},
              f"block_copy [{fname}]: a call captured in a CUDA graph gives {nodes}")
    print("phase 2b: block_copy is one device kernel a call under the good plan and each bad "
          "one (one kernel node, no memset, in a captured CUDA graph)")
    for fname, (plan, budget) in fixture_plans.items():
        # a finite band and output: the NaN tail must be the kernel's own
        out, obuf = guarded((n,), torch.float32, dev, fill=-3.25)
        copy_ops.launch(plan, (out,), x)
        torch.cuda.synchronize()
        check(bool((obuf[:BAND] == -3.25).all() and (obuf[-BAND:] == -3.25).all()),
              f"block_copy [{fname}] wrote a guard band")
        got, want = out.cpu(), block_copy_ref(xc, plan)
        rules = sorted({f.rule for f in audit_launch_plan(plan, name=fname, budget_bytes=budget)})
        check(rules == FIXTURE_RULES[fname], f"block_copy [{fname}]: analyzer gives {rules}")
        if fname == "index_map_overshoot":
            # the last block reads one block past x: the poisoned band on the
            # card, the last block inside x in the interpreter (clamped)
            tail = slice(n - 128, n)
            check(torch.equal(got[: n - 128], want[: n - 128]), "overshoot: head differs")
            check(bool((got[tail] == -7.5).all()), "overshoot: last block did not read the band")
            check(torch.equal(want[tail], xc[tail]), "overshoot: interpreter did not clamp")
            err = float((got[: n - 128] - want[: n - 128]).abs().max())
            what = "last block read the poisoned band where the interpreter clamps"
        else:
            check(torch.equal(torch.nan_to_num(got, nan=1e30), torch.nan_to_num(want, nan=1e30)),
                  f"block_copy [{fname}] differs from the plan interpreter")
            ok = ~torch.isnan(want)
            err = float((got[ok] - want[ok]).abs().max())
            what = (f"equal to the interpreter, {int((~ok).sum())} elements left NaN"
                    if fname == "tail_dropping_grid" else
                    f"exact; {plan.launches[0].dynamic_smem} B of staging > the {budget} B budget")
            if fname == "vmem_over_budget":
                check(plan.launches[0].dynamic_smem > budget, "hog plan within its budget")
        ms = device_ms(lambda: block_copy(x, plan))
        plain_ms = device_ms(lambda: block_copy_ref(x, plan))
        library_ms = device_ms(lambda: x.clone())
        nbytes = 2 * n * 4
        rows[fname] = dict(
            name=fname, route="cuda", source="src/repro_torch/csrc/block_copy.cu",
            replaces=FIXTURE_REPLACES[fname], launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=library_ms,
        )
        print(f"phase 2b: block_copy [{fname}]: analyzer {rules}; {what}; device time: "
              f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, clone {library_ms:.6f} ms, "
              f"bound {rows[fname]['bound_ms']:.7f} ms (bytes)")
    smoke = block_copy.launches
    good_ms, clone_ms = device_ms(lambda: block_copy(x, good)), device_ms(lambda: x.clone())
    print(f"phase 2b: block_copy [good plan]: device time: kernel {good_ms:.6f} ms, clone "
          f"{clone_ms:.6f} ms")
    for row in rows.values():
        row["smoke_launches"] = smoke
    print(f"phase 2b: block_copy wrapper launches in this phase: {smoke}")
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
    Returns (summary, launches, host syncs inside the ticks, ticks/s,
    all_gather calls)."""
    from repro_torch.core.engine import summarize
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.block_copy import block_copy
    from repro_torch.profile_tick import counting_gathers

    torch.cuda.synchronize()
    for w in (*WRAPPERS.values(), block_copy):
        w.launches = 0
    with warnings.catch_warnings(record=True) as caught, counting_gathers() as gathers:
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
    check(block_copy.launches == 0, f"block_copy launched {block_copy.launches} times on a main path")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    for w in syncs[:3]:
        print(f"  sync: {w.message} ({w.filename}:{w.lineno})")
    check(ts.shape == (ticks, 11), f"timeseries shape {tuple(ts.shape)}")
    out = summarize(eng.cfg, final, ts.cpu().numpy())
    return out, launches, len(syncs), ticks / wall, len(gathers)


def want_launches(cfg, ticks, sharded):
    """The flat tick runs its rounds as one bitmap_fit_rounds, the sharded
    tick as one bitmap_fit_rounds_blocked; the one-round bitmap_fit and
    bitmap_fit_blocked on none. Both ticks address with one
    utility_topk_address and refresh with one zone_aggregate_members; the
    tile entries utility_topk and zone_aggregate run on none."""
    return {"bitmap_fit": 0, "bitmap_fit_blocked": 0,
            "bitmap_fit_rounds": 0 if sharded else ticks,
            "bitmap_fit_rounds_blocked": ticks if sharded else 0, "utility_topk": 0,
            "utility_topk_address": ticks, "zone_aggregate": 0, "zone_aggregate_members": ticks,
            "survival_scan": ticks if cfg.memory.enabled else 0}


# the sharded tick's all_gathers: s_true, run_true, the rounds, zS, zH
GATHERS_A_TICK = 5


def check_run(tag, out, launches, want, syncs, gathers=0, want_gathers=0):
    check(launches == want, f"[{tag}] launch counts {launches} != {want}")
    check(syncs == 0, f"[{tag}] {syncs} host syncs inside the ticks")
    check(gathers == want_gathers, f"[{tag}] {gathers} all_gather calls, want {want_gathers}")
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
        out, launches, syncs, tps, _ = drive(eng, s, eng.draws(lam, s.zstart.shape[0], 0), TICKS)
        add(totals, launches)
        tag = "airlock" if airlock else "kernel-oom"
        print(f"phase 3 [{tag}]: {tps:.1f} ticks/s, "
              f"exec_survival_ratio={out['exec_survival_ratio']:.6f} "
              f"oom_kill_l={out['oom_kill_l']} "
              f"completed_success_ratio={out['completed_success_ratio']:.6f} "
              f"started={out['started']} suspended={out['suspended_cnt']} "
              f"launches={launches} host_syncs_in_ticks={syncs}")
        check_run(tag, out, launches, want_launches(cfg, TICKS, sharded=False), syncs)
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


def phase5(dev, totals):
    from repro_torch.core.engine import LaminarEngine
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine
    from repro_torch.profile_tick import exp7_config

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
        out, launches, syncs, tps, gathers = drive(eng, s, eng.draws(lam, Z, 0), EXP7_TICKS)
        add(totals, launches)
        outs[tag] = out
        print(f"phase 5 [{tag}]: {tps:.1f} ticks/s, arrived={out['arrived']} "
              f"started={out['started']} completed={out['completed']} "
              f"start_success_ratio={out['start_success_ratio']:.6f} "
              f"launches={launches} host_syncs_in_ticks={syncs} "
              f"all_gather_calls_per_tick={gathers / EXP7_TICKS:g}")
        sharded = tag != "flat"
        check_run(tag, out, launches, want_launches(cfg, EXP7_TICKS, sharded), syncs, gathers,
                  GATHERS_A_TICK * EXP7_TICKS if sharded else 0)
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
        out, launches, syncs, tps, gathers = drive(eng, s, eng.draws(lam, s.zstart.shape[0], 0),
                                                   STORM_TICKS)
        add(totals, launches)
        tag = "storm, airlock" if airlock else "storm, kernel-oom"
        print(f"phase 6 [{tag}]: {tps:.1f} ticks/s, node_failures={out['node_failures']} "
              f"node_recoveries={out['node_recoveries']} evicted={out['evicted']} "
              f"evicted_killed={out['evicted_killed']} "
              f"exec_survival_ratio={out['exec_survival_ratio']:.6f} "
              f"completed_success_ratio={out['completed_success_ratio']:.6f} "
              f"started={out['started']} launches={launches} host_syncs_in_ticks={syncs} "
              f"all_gather_calls_per_tick={gathers / STORM_TICKS:g}")
        check_run(tag, out, launches, want_launches(cfg, STORM_TICKS, sharded=True), syncs,
                  gathers, GATHERS_A_TICK * STORM_TICKS)
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
    from repro_torch.profile_tick import WARMUP_TICKS, exp5_config, exp7_config

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
            # bitmap_fit_rounds takes the inputs of one tick of the main
            # path: Exp5's tick 200 (profile_tick's), Exp7's last
            for label, cfg, tick in (
                    ("Exp5", exp5_config(False, full=True, ticks=TICKS), WARMUP_TICKS),
                    ("Exp7", exp7_config(), EXP7_TICKS - 1)):
                geo = init_numpy(cfg, 0)
                Z, M = geo["zmember"].shape
                geometries[label] = (
                    dict(N=cfg.num_nodes, P=cfg.probe_capacity, K=cfg.candidate_k, Z=Z, M=M,
                         W=cfg.atoms_per_node // 32),
                    (geo["zmember"], geo["zmask"]),
                    (cfg, tick),
                )
            rows, checked = phase2(dev, geometries)
            t1 = time.perf_counter()
            rows.update(phase2b(dev, checked))
            print(f"phase 2b: {time.perf_counter() - t1:.1f} s wall")
            totals = {name: 0 for name in WRAPPERS}
            gloo = dist.new_group(ranks=[0], backend="gloo")
            for k, run in ((3, lambda: phase3(dev, totals)), (4, lambda: phase4(dev, gloo)),
                           (5, lambda: phase5(dev, totals)), (6, lambda: phase6(dev, totals))):
                t1 = time.perf_counter()
                run()
                print(f"phase {k}: {time.perf_counter() - t1:.1f} s wall")
            for name, n in totals.items():
                rows[name]["launches"] = n  # the fixture rows keep 0: on no main path
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
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
