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
     gap; ``node_view`` (the tick's true node view in one launch) on the
     words of the flat engine's own tick at Exp5 and Exp7, timed against
     its plain version (the unpack, sum and max-run chain it replaced), and
     at its corners (``view_edge_cases``: all free, none free, runs across
     atoms 31/32 and to the top atom, alternating atoms, bits past 48 and
     80 atoms), bit-equal;
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
     ticks each, through ``simulate`` (the compiled run: the tick captured
     once as a CUDA graph and replayed); check the launch counts (one
     ``node_view``, one ``bitmap_fit_rounds``, one ``utility_topk_address``
     and one ``zone_aggregate_members`` a tick; no one-round ``bitmap_fit`` and no
     tile ``utility_topk`` or ``zone_aggregate``), the task-conservation
     identity and the host syncs;
  4. run 64-node configs on the CPU (plain versions) and on the card
     (kernels) with the same draws and compare every integer metric and the
     per-tick timeseries: Exp5 Airlock off and on, the six scenario presets
     with Airlock on, and storm through the zone-sharded engine;
  5. Exp7's top cell (65 536 nodes, 131 072 slots, 100 ticks): the flat
     engine and the zone-sharded engine with the same draws, both compiled
     (the sharded tick captured with its NCCL gathers); ticks/s, the
     traffic model, equal outputs; on the sharded run one
     ``bitmap_fit_rounds_blocked`` a tick, no one-round
     ``bitmap_fit_blocked``, and the five ``all_gather_into_tensor`` calls
     of a tick made at the warm-up and the capture (none on the flat run);
     the sharded ticks/s eager (``make_step`` with its mesh plane) beside
     captured;
  6. the storm scenario at Exp6's full geometry (5000 nodes, 65 536 slots,
     memory on) through the zone-sharded engine, Airlock off then on: node
     failures, kills only without Airlock, task conservation, the launches
     and gathers of phase 5's sharded run; sharded ticks/s eager, captured,
     captured, eager;
  7. the Slurm-, Ray- and Flux-like baselines (``repro_torch.core.baselines``,
     plain PyTorch, no kernel): each at Exp1's geometry (5000 nodes, rho
     0.9, capacity 1 << 15; slurm also at Exp1b's 1 << 17) for 600 ticks,
     its ticks/s, 0 host syncs in the steps, 0 kernel launches, the task
     accounting bounds of ``tests/test_baselines.py`` and its signature
     (slurm saturated, ray spillbacks, flux rollbacks); each
     ``RUNNERS`` entry on the card at 64 nodes; then CPU against CUDA with
     one generator's draws (every ``BaseMetrics`` field, summary entry,
     per-tick series entry and the final state equal) at 64 nodes under
     stationary and storm, at Exp1's geometry for 200 ticks (the lock
     convoy and the root choke acting) and ray on the CPU tests' stressed
     configuration (its USL acting);
  8. the LM serving path (``repro_torch.models``, ``sched``, ``launch.serve``;
     plain PyTorch, no hand-written kernel) at qwen3-1.7b's full width (28
     layers, d_model 2048, vocab 151 936, random weights from seed 0): (a)
     decode after prefill against forward's last logits at S = 2048
     (streaming attention) and S = 24 (dense), in float32 and bfloat16
     compute, rtol = atol = 0.05 (bfloat16 at S = 2048: 2**-5 of the
     logits' scale), prefill ms; the serve driver's decode
     (``launch.serve.CompiledDecode``: a CUDA graph a batch size) at B = 1,
     2 and 4 equal to eager ``lm.decode_step`` bit for bit at positions 10,
     37 and 95, decode ms captured and eager, peak memory, and a profiled
     decode step eager and replayed (its graph's nodes); (c)
     ``launch.serve`` at full width (24 requests, 2 replicas, 120 ticks) on
     the captured decode, its emitted tokens and stats equal to the same
     loop on the eager decode and its stats to a CPU run at ``--smoke``,
     its tokens/s both ways; (b) the width cut to 2 layers on the card and the CPU with
     the same parameters, greedy tokens equal where the margin is clear;
     (d) ``moe_ffn`` at olmoe-1b-7b's layer width on
     ``bench_moe_router.py``'s 2048-token traffic, dropped slots and loads
     equal to the CPU's; every launch counter reads 0 after it;
  9. the training path (``repro_torch.train``, ``launch.train``; plain
     PyTorch, no hand-written kernel) and the RG-LRU / SSD families: (a) the
     train driver (``launch.train.run``) at qwen3-1.7b's full width cut to
     2 of its 28 layers (float32 parameters, bfloat16
     compute, remat per block), batch 2 x seq 4096, 6 steps with a
     checkpoint every 4: the losses (finite), ms a step, tokens/s, peak
     memory, then a restart from the newest checkpoint (3 steps, as
     ``tests/test_train.py`` counts) and a profiled eager step; the
     trainer's step is compiled (``launch.steps.CompiledTrainStep``: its
     first step eager as the warm-up, then a CUDA graph replayed), so the
     run and the restart each capture once; (d) at (a)'s config, the
     compiled step against eager ``make_train_step`` from one init and
     batches, 6 steps: bit for bit, else within the CPU tests' float32
     bounds with the gap of two eager runs beside it; ms a step, tokens/s,
     allocated and reserved peaks of each; the replay's host enqueue ms,
     its profiled device busy share beside (a)'s eager one, and the
     graph's nodes (no host memcpy, no hand-written kernel); (b) the width cut
     to 2 layers, one train step on the card and on the CPU with the same
     parameters: float32 loss, grad norm and parameters within the CPU
     tests' bounds, bfloat16 loss within 2**-5, and decode after prefill
     against forward at S = 2048; (c) mamba2-130m and recurrentgemma-2b at
     full width: decode after prefill against forward at S = 2048 (float32
     and bfloat16), forward and decode ms, one train step (seq 2048 / 1024)
     and peak memory; every launch counter reads 0 after it;
  10. the device mesh (``launch.mesh``, ``parallel.sharding``; plain
     PyTorch and DTensor, no hand-written kernel): (a) the train driver with
     phase 9 (a)'s own arguments and depth plus ``mesh="1x1"`` (a ``DeviceMesh`` of
     the one-rank NCCL group; parameters, moments and batches DTensors
     placed by the sharding rules; the step compiled as in 9 (a), DTensor's
     dispatch and its one-rank collectives in the graph), its losses
     bit-equal to 9 (a)'s (else
     the gap printed and held to the CPU tests' float32 bound 1e-6), a
     restart, ms a step, tokens/s, peak memory and a profiled step's aten
     ops beside 9 (a)'s; (b) in a CPU process of its own, started beside
     (a): the dry-run of qwen3-1.7b x train_4k on the (16, 16) and
     (2, 16, 16) production meshes (a fake process group; per-device
     FLOPs, bytes and collective bytes by kind) and the H100 roofline at 9
     (a)'s shape on a (1, 1) mesh beside 9 (a)'s measured ms a step; every
     launch counter reads 0 after it;
  11. the lockstep engine (``LaminarEngine.init_batch`` / ``run_batch``:
     the flat tick under ``torch.func.vmap``, each hot-path kernel one
     launch of its entry with the seed axis for all seeds): (a) Exp5 at
     5000 nodes / 65 536 slots, Airlock on, seeds 0 to 3, 200 ticks: the
     lockstep run on the card equals the four sequential runs on the card
     (every integer
     metric and timeseries, seed by seed, from the same ``init_batch`` slice
     and generators), each entry's launch counter up by 200, once a tick,
     not once a seed; 0 host syncs in the ticks; (b) the lockstep run on the
     card equals the lockstep run on the CPU at phase 4's 64-node geometry
     on one CPU generator's draws; (c) each entry with the seed axis on the
     inputs of the lockstep tick 200 (four seeds' states and draws) against
     its plain version seed by seed, with phase 2's exactness, its device
     ms beside the bound (the seeds' bytes) in its table row, under its plan
     in guard bands as phase 2b, and the clusters the card holds at once;
     (d) seed-ticks/s
     of lockstep B = 1, 4, 8 and of sequential B = 4, and one profiled
     batched tick at B = 8 (aten ops, device kernels, device busy, host ms);
  12. the compiled run (``core.scan``: ``simulate``, ``simulate_batch`` and
     the baselines' ``simulate`` capture one tick once as a CUDA graph and
     replay it): (a) the captured runs equal ``make_step`` driven by hand on
     the card, bit for bit, on every integer metric, ``lat_hist``, the
     series and every leaf of the final state: Exp5 at 5000 nodes / 65 536
     slots, Airlock off and on, 400 ticks; the storm and diurnal presets
     there, 200 ticks; lockstep seeds 0 to 3, Airlock on, 200 ticks; slurm,
     ray and flux at Exp1's geometry, 300 ticks; one run on draws from a CPU
     generator (copied into the graph's buffers before each replay); the
     zone-sharded engine on the one-rank NCCL group (its tick captured with
     its five gathers) at Exp5 Airlock off and on, 800 ticks, storm, 400,
     and seeds 0 and 24 (equal (Z, M), other zones) through one engine, a
     compiled tick each, 0 host syncs in 20 replays;
     (b) each captured tick's graph: its hand-written kernel nodes (named
     by ``cuFuncGetName``) hold each entry as often as a tick launches it,
     once for all seeds in the lockstep graph, the blocked rounds in the
     sharded graph (its NCCL kernel nodes counted apart), the baselines'
     none; no
     memcpy node touches host memory; the runs make 0 host syncs; (c)
     captured against eager, each on its own host clock ending in a
     synchronize: Exp5 ticks/s (Airlock off and on; eager, captured,
     captured, eager), Exp7's top cell flat (100 ticks), lockstep
     seed-ticks/s at B = 1, 4, 8 (eager: 11 (d)'s), each baseline's
     ticks/s; (d) the replayed tick's profile (``profile_tick``): host ms a
     replay, device busy, device kernels a replay, flat, sharded and at
     B = 8;
  13. the examples and dev smokes (``examples/torch_*.py``,
     ``scripts/torch_smoke_*.py``), in this process through each one's
     ``main(argv)`` on the card, each run's wall time printed with the
     card's name and power limit: quickstart (2000 ticks) and
     cluster_survival (Airlock off and on, 2400 ticks each): the printed
     text equals each module's ``report``, every printed number finite,
     task conservation, L-task OOM kills 0 with Airlock on, and in each
     run's captured graph the tick kernels (all five with memory on, the
     four others with it off), their launches its kernel nodes times its
     replays; the serve example at its defaults (its stats line); the
     train example at ``TRAIN_EXAMPLE_STEPS`` steps (cut from 200) into a
     temporary folder (finite losses, its lines); the engine smoke (two runs
     on one engine, the second a replay of the first's capture), the
     baselines smoke (no hand-written kernel in their graphs) and the models
     smoke on all 10 archs (finite loss and decode logits, right shapes);
  14. print the kernel table as JSON, the card's name and power limit, and
     last the result line.

Every launch counter is set to 0 just before each run of phases 3, 5, 6, 7,
8, 9, 10, 11, 12 and 13 and read just after. A compiled run's launches are its
captured graph's hand-written kernel nodes (``kernel_bench.graph_census``,
named by ``cuFuncGetName``) times its replays: its wrappers run only at the
warm-up and the capture; the zone-sharded run is compiled too (phases 5, 6,
12). The table's ``launches`` sums the runs of phases 3, 5 and 6 and phase
11 (a)'s lockstep run (0 for the three fixture rows, whose
``smoke_launches`` counts phase 2b's own); an entry's ``seed_axis`` holds
phase 11 (c)'s call with the seed axis.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import re
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
PARITY_TICKS = 200  # 400 until the sharded captures came (the script's time)
SCENARIO_TICKS = 200  # phase 4's scenario presets
EXP7_TICKS = 100  # bench_exp7_scale.py NUM_TICKS
# phase 6's horizon, cut from 2400 ticks (Exp6's) when phase 11 came
STORM_TICKS = 1200
# phase 7: the baselines at Exp1's geometry (benchmarks/bench_exp1_mixed_load.py
# runs them at capacity 1 << 15 for 60 000 ticks; bench_exp1b_scale_contrast.py
# runs slurm at 1 << 17), cut to BASELINE_TICKS, and CPU against CUDA
BASELINE_TICKS = 600
BASELINE_PARITY_TICKS = 200
EXP1_CAPACITY = 1 << 15
EXP1B_CAPACITY = 1 << 17
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
    "node_view": "none (src/repro/core/zhaf.py:49, plain jnp)",
}
# the entries whose outputs must equal the plain version's bit for bit, the
# floats included (the others' float outputs: rtol 1e-5)
EXACT = ("survival_scan", "utility_topk_address", "node_view")
# phase 11: the lockstep engine at Exp5 (benchmarks/common.py run_seeds runs
# four seeds a batch)
BATCH_SEEDS = [0, 1, 2, 3]
BATCH_TICKS = 200
BATCH_SIZES = (1, 4, 8)  # (d): lockstep seed-ticks/s
BATCH_WARMUP, BATCH_TIMED = 50, 50  # (d): ticks before and in the timed window
# phase 12: the compiled run against make_step driven by hand. The flat and
# baseline runs of (a) were halved (800, 400, 600 ticks) and the timed
# windows of 12 (c), 6 and 11 (d) too (300, 100 ticks) when the sharded runs
# came, to keep the script within 60 % of its time limit on a slow host
FLAT_TICKS = 400  # (a) Exp5, flat
FLAT_PRESET_TICKS = 200  # (a) storm and diurnal at Exp5's geometry, flat
CAPTURED_BASELINE_TICKS = 300  # (a) the baselines at Exp1's geometry
PRESET_TICKS = 400  # (a) storm, zone-sharded
HOST_FED_TICKS = 200  # (a) draws from a CPU generator
RATE_WARMUP, RATE_TICKS = 100, 150  # (c) ticks before and in the timed window
# (a) the zone-sharded run: two seeds whose Exp5 zones differ and whose (Z, M)
# shapes (20, 301) are equal, through one engine
GEOMETRY_SEEDS = (0, 24)
GEOMETRY_TICKS = 100


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def wrappers() -> dict:
    """Every hand-written entry's wrapper by name (``kernels.ENTRIES``);
    each counts its launches on itself."""
    from repro_torch.kernels import ENTRIES

    return {name: e.wrapper for name, e in ENTRIES.items()}


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


def survival_work(args):
    """(bytes, operations) of survival_scan, fixed by its shapes: the eight
    columns, base and the tick read once, pressure and the four masks
    written once; about forty operations a slot and ten a node."""
    P, N = args[0].shape[0], args[8].shape[0]
    return P * (7 * 4 + 1) + N * 4 + 4 + N * 4 + 4 * P, P * 40 + N * 10


def view_work(args):
    """(bytes, operations) of node_view, fixed by its shapes: every word read
    once, the two counts of each row written once; about twenty integer
    operations a word."""
    words = args[0]
    rows = words.numel() // words.shape[-1]
    return 4 * words.numel() + 8 * rows, 20 * words.numel()


def work(name, case, want):
    """(bytes, operations) a kernel entry must move and do on a case: from
    the case where its shapes fix them, else from the data."""
    if case[2] is not None:
        return case[2:4]
    if name == "survival_scan":
        return survival_work(case[0])
    if name == "bitmap_fit_rounds":
        return rounds_work(case[0], case[1], want)
    if name == "bitmap_fit_rounds_blocked":
        return rounds_blocked_work(case[0], case[1], want)
    if name == "utility_topk_address":
        return address_work(case[0], case[1], want)
    if name == "node_view":
        return view_work(case[0])
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
    if name == "utility_topk_address" and args[0].dim() == 1:  # one seed's columns
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
    from repro_torch.kernels import ENTRIES
    from repro_torch.kernels.bitmap_fit import (
        bitmap_fit_blocked_ref,
        bitmap_fit_ref,
        bitmap_fit_rounds_blocked_ref,
        bitmap_fit_rounds_ref,
    )
    from repro_torch.kernels.node_view import node_view_ref
    from repro_torch.kernels.survival_scan import survival_scan_ref
    from repro_torch.kernel_bench import address_edge_cases, address_inputs, address_kw
    from repro_torch.kernels.utility_topk import utility_topk_address_ref, utility_topk_ref
    from repro_torch.kernels.zone_aggregate import zone_aggregate_members_ref, zone_aggregate_ref

    wrapper = wrappers()
    refs = {"bitmap_fit": bitmap_fit_ref, "bitmap_fit_blocked": bitmap_fit_blocked_ref,
            "bitmap_fit_rounds": bitmap_fit_rounds_ref,
            "bitmap_fit_rounds_blocked": bitmap_fit_rounds_blocked_ref,
            "utility_topk": utility_topk_ref,
            "utility_topk_address": utility_topk_address_ref,
            "zone_aggregate": zone_aggregate_ref,
            "zone_aggregate_members": zone_aggregate_members_ref,
            "survival_scan": survival_scan_ref, "node_view": node_view_ref}
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
    from repro_torch.kernel_bench import view_edge_cases, view_inputs

    ragged["node_view"] = (*view_inputs(37, 2, 61, seed=1), None, None)
    checked = {"ragged": {}}
    for name, case in ragged.items():
        checked["ragged"][name] = (case,
                                   check_kernel(name, wrapper[name], refs[name], case, dev)[1])
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
            want = check_kernel("survival_scan", wrapper["survival_scan"], survival_scan_ref,
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
        want = check_kernel("bitmap_fit_rounds", wrapper["bitmap_fit_rounds"],
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
        want = check_kernel("bitmap_fit_rounds_blocked", wrapper["bitmap_fit_rounds_blocked"],
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
        want = check_kernel("utility_topk_address", wrapper["utility_topk_address"],
                            utility_topk_address_ref, case, dev)[1]
        checked[f"address {cname}"] = {"utility_topk_address": (case, want)}
    print(f"phase 2: utility_topk_address edge cases ({', '.join(address_edge_cases())}): "
          "bit-equal to the plain version on every output")
    for cname, (args, kw) in view_edge_cases().items():
        case = (args, kw, None, None)
        want = check_kernel("node_view", wrapper["node_view"], node_view_ref, case, dev)[1]
        checked[f"view {cname}"] = {"node_view": (case, want)}
    print(f"phase 2: node_view edge cases ({', '.join(view_edge_cases())}): bit-equal to the "
          "plain version")
    rows = {}
    from repro_torch.core.state import ADDRESSING
    from repro_torch.profile_tick import print_traffic, rounds_traffic, tick_calls

    recorded = ("bitmap_fit_rounds", "utility_topk_address", "zone_aggregate_members",
                "node_view")
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
            err, want = check_kernel(name, wrapper[name], refs[name], case, dev)
            checked[label][name] = (case, want)
            args = to_dev(case[0], dev)
            kw = case[1]
            nbytes, nops = work(name, case, want)
            ms = device_ms(lambda: wrapper[name](*args, **kw))
            plain_ms = device_ms(lambda: refs[name](*args, **kw))
            eager_ms = call_ms(lambda: wrapper[name](*args, **kw))
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = nops / FP32_OPS_PER_S * 1e3
            row = dict(
                name=name, route="cuda", source=f"src/repro_torch/csrc/{ENTRIES[name].source}.cu",
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
        want = check_kernel("zone_aggregate_members", wrapper["zone_aggregate_members"],
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


def guard_bands(dev, label, per):
    """Each entry of ``per`` (name -> (case, the plain version's outputs))
    launched through its launch function and plan into outputs (and
    scratch) that sit in sentinel-filled buffers with guard bands: every
    output fully written (LC301 on the card), no band touched (LC302), equal
    to the plain version. A plan with a seed axis gives each output a band
    of its own."""
    from repro_torch.kernels import ENTRIES

    for name, (case, want) in per.items():
        args, kw = to_dev(case[0], dev), case[1]
        plan = ENTRIES[name].plan(*args, **kw)
        views = [guarded(o.shape, o.dtype, dev) for o in plan.outputs]
        extra = {}
        if plan.scratch_words:  # survival_scan and the rounds
            scratch, sbuf = guarded((plan.scratch_words,), torch.int32, dev)
            extra["scratch"] = scratch
        ENTRIES[name].launch(plan, [v for v, _ in views], *args, **kw, **extra)
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


def phase2b(dev, checked):
    """Attributes against plans, guard bands around every entry's outputs,
    and the block_copy kernel under the good plan and the three bad ones.
    Returns the table rows of the three fixture kernels."""
    import importlib

    from repro_torch.analysis.kernel_contract import PER_BLOCK, audit_launch_plan
    from repro_torch.kernels import ENTRIES, SOURCES, _build
    from repro_torch.kernels.bitmap_fit import ops as bitmap_ops
    from repro_torch.kernels.block_copy import block_copy, block_copy_ref
    from repro_torch.kernels.block_copy import ops as copy_ops
    from repro_torch.kernels.block_copy import plan as copy_plan
    from repro_torch.kernels.survival_scan import ops as surv_ops

    # -- compiled attributes against every plan ------------------------------
    attrs = {}
    for name in SOURCES:  # each package, named as its source
        mod = importlib.import_module(f"repro_torch.kernels.{name}.plan")
        for k, kernel in enumerate(mod.KERNELS):
            attrs[kernel] = a = _build.attrs(name, k)
            print(f"phase 2b: {name}.cu {kernel}: {a['registers']} registers/thread, "
                  f"{a['static_smem']} B static shared memory, max {a['max_threads']} "
                  f"threads/block")
    fixture_plans = load_fixture_plans()
    plans = [ENTRIES[name].plan(*case[0], **case[1])
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
        plan = ENTRIES["survival_scan"].plan(*case[0], **case[1])
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
        plan = ENTRIES["bitmap_fit_rounds"].plan(*args, **kw)
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
        plan = ENTRIES["bitmap_fit_rounds_blocked"].plan(*args, **kw)
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
        guard_bands(dev, label, per)
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


def graph_launches(runs) -> dict:
    """The hand-written launches of compiled runs (``core.scan.watching``'s
    ``(compiled, replays)`` pairs): each graph's hand-written kernel nodes,
    by entry (``kernel_bench.tick_entries``), times its replays."""
    from repro_torch.kernel_bench import graph_census, tick_entries

    launches = dict.fromkeys(wrappers(), 0)
    for compiled, replays in runs:
        for entry, n in tick_entries(graph_census(compiled.graph)["names"]).items():
            launches[entry] = launches.get(entry, 0) + n * replays
    return launches


def counted(run):
    """``run()`` as one main-path run: every launch counter set to 0 just
    before, read just after. Returns (its result, launches, host syncs
    inside it, seconds to its end on the device, all_gather calls). The
    launches of a compiled run (``core.scan``) are its graph's kernel
    nodes times its replays (:func:`graph_launches`), of an eager run (the
    sharded engine's) the wrappers' counts."""
    from repro_torch.core.scan import watching
    from repro_torch.profile_tick import counting_gathers

    torch.cuda.synchronize()
    counters = wrappers()
    for w in counters.values():
        w.launches = 0
    with warnings.catch_warnings(record=True) as caught, counting_gathers() as gathers, \
            watching() as runs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            result = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if runs:
        launches = graph_launches(runs)
    else:
        launches = {name: w.launches for name, w in counters.items()}
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    for w in syncs[:3]:
        print(f"  sync: {w.message} ({w.filename}:{w.lineno})")
    return result, launches, len(syncs), wall, len(gathers)


def drive(eng, s, draws, ticks):
    """One main-path run: counters set to 0 just before, read just after.
    Returns (summary, launches, host syncs in the run, ticks/s,
    all_gather_into_tensor calls, the census of the run's graph)."""
    from repro_torch.core.engine import summarize
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census

    with watching() as runs:
        (final, ts), launches, syncs, wall, gathers = counted(
            lambda: eng.simulate(s, draws, ticks))
    check(ts.shape == (ticks, 11), f"timeseries shape {tuple(ts.shape)}")
    out = summarize(eng.cfg, final, ts.cpu().numpy())
    return out, launches, syncs, ticks / wall, gathers, graph_census(runs[0][0].graph)


def want_launches(cfg, ticks, sharded):
    """The flat tick runs its rounds as one bitmap_fit_rounds, the sharded
    tick as one bitmap_fit_rounds_blocked; the one-round bitmap_fit and
    bitmap_fit_blocked on none. Both ticks build the node view with one
    node_view, address with one utility_topk_address and refresh with one
    zone_aggregate_members; the tile entries utility_topk and zone_aggregate
    and the fixtures' block_copy run on none."""
    return {"bitmap_fit": 0, "bitmap_fit_blocked": 0,
            "bitmap_fit_rounds": 0 if sharded else ticks,
            "bitmap_fit_rounds_blocked": ticks if sharded else 0, "utility_topk": 0,
            "utility_topk_address": ticks, "zone_aggregate": 0, "zone_aggregate_members": ticks,
            "survival_scan": ticks if cfg.memory.enabled else 0, "node_view": ticks,
            "block_copy": 0}


# the sharded tick's all_gathers: s_true, run_true, the rounds, zS, zH. A
# compiled sharded run calls them at its warm-up and its capture; its graph
# replays the capture's
GATHERS_A_TICK = 5
CAPTURE_GATHERS = 2 * GATHERS_A_TICK
# a sharded run reads its zone geometry's digest on the host once, before
# its first tick (the key of its compiled tick); its ticks read nothing
SHARDED_RUN_SYNCS = 1


def check_run(tag, out, launches, want, syncs, gathers=0, want_gathers=0, want_syncs=0):
    check(launches == want, f"[{tag}] launch counts {launches} != {want}")
    check(syncs == want_syncs, f"[{tag}] {syncs} host syncs in the run, want {want_syncs}")
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
        out, launches, syncs, tps, _, _ = drive(eng, s, eng.draws(lam, s.zstart.shape[0], 0),
                                                TICKS)
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
    from repro_torch.core.engine import LaminarEngine, make_step
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
        out, launches, syncs, tps, gathers, census = drive(eng, s, eng.draws(lam, Z, 0),
                                                           EXP7_TICKS)
        add(totals, launches)
        outs[tag] = out
        sharded = tag != "flat"
        print(f"phase 5 [{tag}]: {tps:.1f} ticks/s captured from init (capture included), "
              f"arrived={out['arrived']} started={out['started']} completed={out['completed']} "
              f"start_success_ratio={out['start_success_ratio']:.6f} "
              f"launches={launches} (graph nodes x replays) host_syncs_in_run={syncs} "
              f"all_gather_into_tensor calls {gathers} (warm-up and capture), "
              f"NCCL kernel nodes a tick {census['nccl']}")
        check_run(tag, out, launches, want_launches(cfg, EXP7_TICKS, sharded), syncs, gathers,
                  CAPTURE_GATHERS if sharded else 0, SHARDED_RUN_SYNCS if sharded else 0)
    step = make_step(cfg, plane=mesh._plane(s))
    eager = EXP7_TICKS / timed(lambda: eager_run(step, s, mesh.draws(lam, Z, 0), EXP7_TICKS))
    captured = EXP7_TICKS / timed(lambda: mesh.simulate(s, mesh.draws(lam, Z, 0), EXP7_TICKS))
    print(f"phase 5 [zone-sharded]: {EXP7_TICKS} ticks from init, ticks/s eager (make_step "
          f"with the mesh plane) {eager:.1f}, captured {captured:.1f} (capture made before)")
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
    from repro_torch.core.engine import make_step
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
        Z = s.zstart.shape[0]
        out, launches, syncs, tps, gathers, census = drive(eng, s, eng.draws(lam, Z, 0),
                                                           STORM_TICKS)
        add(totals, launches)
        tag = "storm, airlock" if airlock else "storm, kernel-oom"
        print(f"phase 6 [{tag}]: {tps:.1f} ticks/s captured from init (capture included), "
              f"node_failures={out['node_failures']} "
              f"node_recoveries={out['node_recoveries']} evicted={out['evicted']} "
              f"evicted_killed={out['evicted_killed']} "
              f"exec_survival_ratio={out['exec_survival_ratio']:.6f} "
              f"completed_success_ratio={out['completed_success_ratio']:.6f} "
              f"started={out['started']} launches={launches} (graph nodes x replays) "
              f"host_syncs_in_run={syncs} all_gather_into_tensor calls {gathers} (warm-up and "
              f"capture), NCCL kernel nodes a tick {census['nccl']}")
        check_run(tag, out, launches, want_launches(cfg, STORM_TICKS, sharded=True), syncs,
                  gathers, CAPTURE_GATHERS, SHARDED_RUN_SYNCS)
        check(out["node_failures"] > 0, f"[{tag}] no node failures")
        if airlock:
            check(out["evicted_killed"] == 0, f"[{tag}] Airlock run killed evicted residents")
        else:
            check(out["evicted_killed"] > 0, f"[{tag}] no disruption kills without Airlock")
        rates = []
        for kind in ("eager", "captured", "captured", "eager"):
            d = eng.draws(lam, Z, 0)
            rates.append(eager_rate(make_step(cfg, plane=eng._plane(s)), s, d)
                         if kind == "eager" else captured_rate(eng.simulate, s, d))
        print(f"phase 6 [{tag}]: ticks {RATE_WARMUP} to {RATE_WARMUP + RATE_TICKS - 1}, "
              f"sharded ticks/s eager, captured, captured, eager: "
              f"{', '.join(f'{r:.1f}' for r in rates)}")


# ---------------------------------------------------------------------------
# phase 7: the Slurm-, Ray- and Flux-like baselines
# ---------------------------------------------------------------------------


def exp1_config():
    """``benchmarks/common.py`` ``bench_cfg(full=True, rho=0.9,
    two_phase=False)``: Exp1's top load point at paper geometry."""
    from repro_torch.core import LaminarConfig

    n = 5000
    return LaminarConfig(
        num_nodes=n, zone_size=min(256, max(32, n // 8)),
        probe_capacity=min(1 << max(13, (n * 8 - 1).bit_length()), 1 << 17),
        max_arrivals_per_tick=512, horizon_ms=30_000.0, rho=0.9, two_phase=False,
    )


def baseline_drive(name, cfg, bcfg, capacity, ticks, device, generator_device=None):
    """One baseline run the way ``RUNNERS[name]`` composes it (``init``, the
    generator-backed draws, ``simulate``, ``summarize_baseline``), with the
    kernel counters at 0 just before the steps and host syncs counted inside
    them. Returns (summary, final state, per-tick series, host syncs,
    ticks/s, kernel launches). Host syncs are counted only where the
    generator lives on the run's device: another generator's values arrive
    by a synchronizing copy."""
    from repro_torch.core.baselines import common as C
    from repro_torch.core.baselines import flux_like, ray_like, slurm_like
    from repro_torch.core.baselines.draws import TorchBaselineDraws

    mod = {"slurm": slurm_like, "ray": ray_like, "flux": flux_like}[name]
    s, lam = mod.init(cfg, 0, capacity, device)
    draws = TorchBaselineDraws(name, cfg, lam, capacity, 0, device, generator_device)
    step = mod.make_step(cfg, bcfg)
    cuda = torch.device(device).type == "cuda"
    count_syncs = cuda and generator_device in (None, device)
    counters = wrappers()
    for w in counters.values():
        w.launches = 0
    if cuda:
        torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            final, ys = C.simulate(step, s, draws, ticks)
        finally:
            if count_syncs:
                torch.cuda.set_sync_debug_mode(0)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = sum(w.launches for w in counters.values())
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    for w in syncs[:3]:
        print(f"  sync: {w.message} ({w.filename}:{w.lineno})")
    out = C.summarize_baseline(cfg, final.metrics, final.tt)
    return out, final, ys.cpu().numpy(), len(syncs), ticks / wall, launches


def engaged(name, bcfg, final):
    """(what, the count its penalty reads, threshold) at the end of the run.
    Nothing joins that count after the step reads it, so a count at the end
    above the threshold means the penalty acted in the last tick."""
    st, shard = final.tt.st, final.tt.shard
    if name == "slurm":
        return "lock convoy", int((st == 1).sum()), bcfg.slurm_convoy_depth
    if name == "ray":
        return "USL", int(((st == 1) & (shard != -1)).sum()), bcfg.ray_usl_depth
    return "root choke", int(((st != 0) & (st != 3)).sum()), bcfg.flux_root_choke


def baseline_parity(tag, name, cfg, bcfg, capacity, ticks, dev):
    """CPU and CUDA runs of one model with one generator's draws (drawn on
    the card, copied to the CPU for the CPU run): every BaseMetrics field,
    summary entry, per-tick series entry and the whole final state equal."""
    from repro_torch.core.baselines.common import state_to_numpy

    t0 = time.perf_counter()
    runs = [baseline_drive(name, cfg, bcfg, capacity, ticks, d, dev) for d in ("cpu", dev)]
    (cpu, cfin, cys, _, cpu_tps, _), (gpu, gfin, gys, _, gpu_tps, _) = runs
    a, b = state_to_numpy(cfin), state_to_numpy(gfin)

    def differ(x, y, path=""):
        if isinstance(x, dict):
            return [d for k in x for d in differ(x[k], y[k], f"{path}{k}.")]
        return [] if x.tobytes() == y.tobytes() else [path[:-1]]

    diff = differ(a, b) + [k for k in cpu if not (cpu[k] == gpu[k] or (
        isinstance(cpu[k], float) and np.isnan(cpu[k]) and np.isnan(gpu[k])))]
    bad = np.nonzero((cys != gys).any(axis=-1))[0]
    what, peak, threshold = engaged(name, bcfg, cfin)
    print(f"phase 7 [{tag}, {name}]: {cfg.num_nodes} nodes, capacity {capacity}, {ticks} ticks, "
          f"started={cpu['started']} disrupt_killed={cpu['disrupt_killed']}, {what} count at the "
          f"end {peak} (threshold {threshold}); {time.perf_counter() - t0:.1f} s (CPU "
          f"{cpu_tps:.1f}, CUDA {gpu_tps:.1f} ticks/s): "
          + ("CPU == CUDA on every metric, summary entry, per-tick series and the final state"
             if not diff and not len(bad) else
             f"first series divergence at tick {bad[:1]}, differing {diff[:8]}"))
    check(not diff and not len(bad), f"[{tag}, {name}] CPU and CUDA baseline runs diverge")
    check(cpu["started"] > 0, f"[{tag}, {name}] degenerate parity run")
    return cfin


def phase7(dev):
    from repro_torch.core import BaselineConfig, LaminarConfig
    from repro_torch.core.baselines import RUNNERS
    from repro_torch.workloads import SCENARIOS

    cfg = exp1_config()
    bcfg = BaselineConfig()
    print(f"phase 7: the baselines at Exp1's geometry ({cfg.num_nodes} nodes, zone size "
          f"{cfg.zone_size}, {cfg.max_arrivals_per_tick} arrivals/tick, rho {cfg.rho}), "
          f"{BASELINE_TICKS} ticks per run (cut from Exp1's 60 000)")
    signature = {"slurm": ("start_success_raw", lambda v: v < 0.5),
                 "ray": ("spillbacks", lambda v: v > 0),
                 "flux": ("rollbacks", lambda v: v > 0)}
    for name, capacity in (("slurm", EXP1_CAPACITY), ("ray", EXP1_CAPACITY),
                           ("flux", EXP1_CAPACITY), ("slurm", EXP1B_CAPACITY)):
        out, final, _, syncs, tps, launches = baseline_drive(name, cfg, bcfg, capacity,
                                                             BASELINE_TICKS, dev)
        key, holds = signature[name]
        accounted = out["started"] + out["failed"] + out["timeout"] + out["in_flight_end"]
        what, peak, threshold = engaged(name, bcfg, final)
        print(f"phase 7 [{name}, capacity {capacity}]: {tps:.1f} ticks/s, arrived={out['arrived']} "
              f"started={out['started']} dropped={out['dropped']} spillbacks={out['spillbacks']} "
              f"rollbacks={out['rollbacks']} start_success_raw={out['start_success_raw']:.6f} "
              f"{what} count at the end {peak} "
              f"(threshold {threshold}) host_syncs_in_steps={syncs} kernel_launches={launches}")
        check(syncs == 0, f"[{name}] {syncs} host syncs inside the steps")
        check(launches == 0, f"[{name}] a baseline launched {launches} hand-written kernels")
        check(accounted <= out["arrived"] + 1
              and accounted >= 0.9 * out["arrived"] - out["dropped"] - 1,
              f"[{name}] task accounting broken")
        check(holds(out[key]), f"[{name}] no signature: {key}={out[key]}")
    small = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024,
                          max_arrivals_per_tick=64, horizon_ms=100.0, rho=0.8)
    for name, run in RUNNERS.items():  # the entry point itself, on the card
        out = run(small, capacity=1 << 12, num_ticks=50)
        check(out["arrived"] > 0, f"[{name}] RUNNERS entry point ran nothing")
    for scenario in ("stationary", "storm"):
        c64 = dataclasses.replace(small, scenario=SCENARIOS[scenario])
        for name in RUNNERS:
            baseline_parity(f"64 nodes, {scenario}", name, c64, bcfg, 1 << 12,
                            BASELINE_PARITY_TICKS, dev)
    for name in RUNNERS:
        fin = baseline_parity("Exp1", name, cfg, bcfg, EXP1_CAPACITY, BASELINE_PARITY_TICKS, dev)
        what, peak, threshold = engaged(name, bcfg, fin)
        if name != "ray":  # Ray's spillbacks stay under its USL depth here
            check(peak > threshold, f"[Exp1, {name}] no {what}")
    # the USL on the card: the CPU tests' stressed configuration (512 nodes,
    # rho 0.9, ray_usl_depth 20)
    stressed = LaminarConfig(num_nodes=512, zone_size=64, probe_capacity=8192,
                             max_arrivals_per_tick=512, horizon_ms=300.0, rho=0.9)
    ray_bcfg = BaselineConfig(ray_usl_depth=20)
    fin = baseline_parity("stressed", "ray", stressed, ray_bcfg, EXP1_CAPACITY,
                          BASELINE_PARITY_TICKS, dev)
    check(engaged("ray", ray_bcfg, fin)[1] > ray_bcfg.ray_usl_depth, "[stressed, ray] no USL")


# ---------------------------------------------------------------------------
# phase 8: the LM serving path at qwen3-1.7b's full width (no hand-written
# kernel: plain PyTorch, as the reference is plain jnp)
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen3-1.7b"  # repro/launch/serve.py's default arch
LONG_PROMPT = 2048  # Sq * Sk > 4 * 512 * 1024: the streaming attention path
SHORT_PROMPT = 24  # the dense path
DECODE_TOL = 0.05  # tests/test_models.py's decode-vs-forward rtol and atol
# bfloat16 bound, a share of the scale, where two orders of computation
# meet: decode after prefill against forward at S = 2048 (streaming
# attention, and the RG-LRU's log-depth scan, against one step at a time;
# ROADMAP C shows qwen3-1.7b's gap to be the reference's own, and
# recurrentgemma-2b's equal to the reference's at 3 and 6 layers), and the
# card against the CPU (phases 8d, 9b). The CPU tests hold the port to the
# reference, one order against the same order, at 2**-7.
BF16_TOL = 2.0**-5
DECODE_BATCHES = (1, 2, 4)  # at most ServeConfig.max_slots = 4 running a replica
DECODE_POSITIONS = (10, 37, 95)  # the graph replays any position (95: S_MAX's last slot)
DECODE_REPLAYS = 20
MOE_ARCH = "olmoe-1b-7b"  # d_model 2048, 64 experts, top-8, d_ff_expert 1024
MOE_TOKENS = 2048  # benchmarks/bench_moe_router.py's traffic
MOE_BOUNCES = 2


def host_ms(fn, reps=10):
    """Wall time of one call ending in a synchronize (host launch cost
    included), the median of ``reps`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def decode_vs_forward(cfg, params, S, B, dev):
    """prefill(S - 1) plus one decode_step against forward's last logits;
    returns (max abs err, logits scale, entries outside rtol = atol =
    DECODE_TOL, prefill ms, forward ms)."""
    from repro_torch.models import lm

    g = torch.Generator(device=dev).manual_seed(S)
    tok = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    full, _ = lm.forward(cfg, params, tok)
    want = full[:, -1].float()
    del full
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    caches = lm.init_cache(cfg, B, S + 4, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, caches = lm.prefill(cfg, params, tok[:, : S - 1], caches)
    torch.cuda.synchronize()
    pf_ms = (time.perf_counter() - t0) * 1e3
    got = lm.decode_step(cfg, params, tok[:, S - 1:], S - 1, caches)[0][:, 0].float()
    check(bool(torch.isfinite(got).all()), f"[S={S}] decode logits not finite")
    d = (got - want).abs()
    outside = int((d > DECODE_TOL + DECODE_TOL * want.abs()).sum())
    return float(d.max()), float(want.abs().max()), outside, pf_ms, fwd_ms


def phase8a(cfg, params, dev):
    """qwen3-1.7b at full width: decode after prefill against forward at S =
    2048 (streaming attention) and S = 24 (dense); prefill and decode
    times."""
    from repro_torch.launch import serve as tserve
    from repro_torch.models import lm

    for S, B in ((LONG_PROMPT, 1), (SHORT_PROMPT, 2)):
        for cd in (torch.float32, torch.bfloat16):
            err, scale, outside, pf_ms, fwd_ms = decode_vs_forward(
                dataclasses.replace(cfg, compute_dtype=cd), params, S, B, dev)
            tag = f"[S={S}, B={B}, {str(cd).removeprefix('torch.')} compute]"
            print(f"phase 8 (a) {tag}: decode after prefill of {S - 1} tokens against forward's "
                  f"last logits: max abs err {err:.4g} at logit scale {scale:.4g}, {outside} of "
                  f"{B * cfg.vocab} outside rtol = atol = {DECODE_TOL}; prefill {pf_ms:.1f} ms, "
                  f"forward {fwd_ms:.1f} ms (first calls)")
            if cd == torch.bfloat16 and S == LONG_PROMPT:
                # bfloat16 over 2047 positions and two attention paths
                # (streaming in forward and prefill, dense in decode): held to
                # the bfloat16 bound the CPU parity tests state
                check(err <= BF16_TOL * scale, f"{tag} decode differs from forward by {err}")
            else:
                check(outside == 0, f"{tag} decode differs from forward by {err}")
    for B in (1, 2):  # prefill again, warm
        g = torch.Generator(device=dev).manual_seed(B)
        tok = torch.randint(0, cfg.vocab, (B, LONG_PROMPT - 1), generator=g, device=dev)
        ms = host_ms(lambda: lm.prefill(cfg, params, tok, lm.init_cache(cfg, B, LONG_PROMPT, dev)),
                     reps=3)
        print(f"phase 8 (a): prefill of {LONG_PROMPT - 1} tokens at B={B}: {ms:.2f} ms "
              f"({B * (LONG_PROMPT - 1) / ms * 1e3:.0f} tokens/s)")
    decode = tserve.CompiledDecode(cfg, params)
    for B in DECODE_BATCHES:
        tok = torch.randint(0, cfg.vocab, (B, 1), device=dev, dtype=torch.int32)

        def eager(at):
            return lm.decode_step(cfg, params, tok, at, lm.init_cache(cfg, B, tserve.S_MAX, dev))[0]

        for at in DECODE_POSITIONS:  # the first call captures B's graph
            got, want = decode(tok, at).clone(), eager(at)
            check(torch.equal(got, want), f"[decode B={B}, position {at}] captured logits differ "
                  f"from eager by {float((got - want).abs().max())}")
        e_ms = host_ms(lambda: eager(10))
        c_ms = host_ms(lambda: decode(tok, 10))
        print(f"phase 8 (a): decode step at B={B}, cache {tserve.S_MAX}, {cfg.n_layers} layers: "
              f"captured logits == eager bit for bit at positions {DECODE_POSITIONS}; eager "
              f"{e_ms:.2f} ms a step ({B / e_ms * 1e3:.1f} tokens/s), captured {c_ms:.2f} ms "
              f"({B / c_ms * 1e3:.1f} tokens/s), host clock ending in a synchronize")
    check(sorted(decode.steps) == list(DECODE_BATCHES), f"decode graphs {sorted(decode.steps)}")
    print(f"phase 8 (a): torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    decode_profile(cfg, params, dev, decode)


def decode_profile(cfg, params, dev, decode, B=2, steps=5):
    """Where a decode step's time goes (the serve driver's step: a fresh
    cache of S_MAX, B = 2), eager and replayed: host wall, aten ops and
    device kernels a step, device busy share, the largest device kernels
    (torch.profiler); for the replay (``decode``'s graph for B) also the
    host enqueue ms a replay and the graph's nodes."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from repro_torch.kernel_bench import graph_census, tick_entries
    from repro_torch.launch import serve as tserve
    from repro_torch.models import lm
    from repro_torch.profile_tick import window

    tok = torch.randint(0, cfg.vocab, (B, 1), device=dev, dtype=torch.int32)
    step = lambda: lm.decode_step(cfg, params, tok, 10, lm.init_cache(cfg, B, tserve.S_MAX, dev))  # noqa: E731
    step()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    dev_us, dev_n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[e.name] = dev_us.get(e.name, 0.0) + e.time_range.elapsed_us()
            dev_n += 1
    n_ops = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    busy = sum(dev_us.values()) / 1e6 / steps
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:4]
    print(f"phase 8 (a): profiled eager decode step (B={B}, cache {tserve.S_MAX}, "
          f"{cfg.n_layers} layers): {wall * 1e3:.2f} ms "
          f"wall, {n_ops / steps:.0f} aten ops (nested ones included) and {dev_n / steps:.0f} "
          f"device kernels a step, device busy {busy * 1e3:.3f} ms = {busy / wall:.1%} of wall; "
          f"largest: " + "; ".join(f"{us / steps / 1e3:.3f} ms {name[:60]}" for name, us in top))

    decode(tok, 10)
    graph = decode.steps[B].graph

    def advance(k):
        for _ in range(k):
            graph.replay()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    advance(DECODE_REPLAYS)
    enqueue = (time.perf_counter() - t0) / DECODE_REPLAYS
    torch.cuda.synchronize()
    finished = (time.perf_counter() - t0) / DECODE_REPLAYS
    w = window(advance, DECODE_REPLAYS)
    c = graph_census(graph)
    hand = tick_entries(c["names"])
    check(not hand, f"the decode graph holds hand-written kernel nodes {hand}")
    busy = "not measured" if w["busy_ms"] is None else \
        f"{w['busy_ms']:.3f} ms = {w['busy_ms'] / w['wall_ms']:.1%} of the profiled wall"
    top = "; ".join(f"{us / 1e3:.3f} ms {name[:60]}" for name, us in w["top_device"][:4])
    print(f"phase 8 (a): replayed decode step (B={B}, {cfg.n_layers} layers; CompiledDecode's "
          f"graph): {finished * 1e3:.3f} ms a replay to its end, host enqueue {enqueue * 1e3:.3f} "
          f"ms; graph nodes: {c['kernel']} kernel (hand-written: none), {c['memcpy']} memcpy "
          f"({c['host_memcpy']} touching host memory), {c['memset']} memset, {c['other']} other; "
          f"profiled {w['wall_ms']:.3f} ms wall, {w['kernels']:.0f} device kernels a replay, "
          f"device busy {busy}; largest: {top}")


class EagerDecode:
    """The serve driver's decode before it was compiled: ``lm.decode_step``
    from a fresh cache of ``S_MAX`` slots, op by op (phase 8 (c)'s
    yardstick, in place of ``CompiledDecode``)."""

    def __init__(self, cfg, params, s_max=None):
        from repro_torch.launch import serve as tserve

        self.cfg, self.params, self.s_max = cfg, params, s_max or tserve.S_MAX

    def __call__(self, tokens, position):
        from repro_torch.models import lm

        cache = lm.init_cache(self.cfg, tokens.shape[0], self.s_max, tokens.device)
        return lm.decode_step(self.cfg, self.params, tokens, position, cache)[0]


def phase8c(cfg, params, dev):
    """The serve driver at full width on the card, on its captured decode;
    its emitted tokens and stats against the same loop on the eager decode
    (same seeds), and its stats against a CPU run of the driver at --smoke
    (they depend only on the numpy generator)."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.scan import watching
    from repro_torch.launch import serve as tserve
    from repro_torch.models import lm

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, emitted, _ = tserve.serve(cfg, params, requests=24, replicas=2, ticks=120,
                                         seed=0, device=dev)
        torch.cuda.synchronize()
        return stats, emitted, time.perf_counter() - t0

    with watching() as runs:
        stats, emitted, wall = run()
    check(not runs, "the serve driver ran an engine tick")
    compiled = tserve.CompiledDecode
    tserve.CompiledDecode = EagerDecode
    try:
        e_stats, e_emitted, e_wall = run()
    finally:
        tserve.CompiledDecode = compiled
    n_tok = sum(len(v) for v in emitted.values())
    smoke = get_smoke(cfg.name)
    cpu_stats, _, _ = tserve.serve(smoke, lm.init_params(smoke, 0, "cpu"), requests=24,
                                   replicas=2, ticks=120, seed=0, device="cpu")
    print(f"phase 8 (c): launch.serve at full width on the card ({cfg.n_layers} layers; 24 "
          f"requests, 2 replicas, 120 ticks, seed 0): {stats}; {n_tok} tokens in {wall:.2f} s "
          f"wall on the captured decode ({n_tok / wall:.1f} tokens/s), {e_wall:.2f} s on the "
          f"eager decode ({n_tok / e_wall:.1f} tokens/s)")
    check(stats == e_stats and emitted == e_emitted,
          f"[serve] captured and eager decode differ: stats {stats} vs {e_stats}, tokens "
          f"{sum(emitted[r] != e_emitted.get(r) for r in emitted)} requests apart")
    check(stats == cpu_stats, f"[serve] card stats {stats} != CPU --smoke stats {cpu_stats}")
    check(stats["completed"] > 0 and n_tok > 0, "[serve] nothing decoded")
    print("phase 8 (c): captured == eager decode on every emitted token and stat; the stats "
          "equal a CPU run of the driver at --smoke")


def phase8b(cfg, dev):
    """The full width cut to 2 layers on the card and on the CPU with the
    same parameters; returns the logits' max difference relative to their
    scale."""
    from repro_torch.models import blocks, lm

    cfg2 = cfg.scaled(n_layers=2)
    p_dev = lm.init_params(cfg2, 1, dev)
    p_cpu = blocks.tree_map(lambda a: a.cpu(), p_dev)
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, cfg.vocab, (2, 32), generator=g, dtype=torch.int32)
    want, _ = lm.forward(cfg2, p_cpu, tok)
    got = lm.forward(cfg2, p_dev, tok.to(dev))[0].cpu()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > diff
    same = got.argmax(-1) == want.argmax(-1)
    print(f"phase 8 (b): {cfg.name} cut to 2 layers (n_layers {cfg.n_layers} -> 2, the only cut), "
          f"2 x 32 tokens, CUDA vs CPU: max logit diff {diff:.4g} at logit scale {scale:.4g} "
          f"({diff / scale:.3g} of it); greedy tokens equal at {int(same.sum())} of "
          f"{same.numel()} positions, {int(clear.sum())} with a CPU top-2 margin above the diff")
    check(bool(torch.isfinite(got).all()), "[2 layers] CUDA logits not finite")
    check(bool(same[clear].all()), "[2 layers] a greedy token differs at a clear margin")
    return diff / scale


def phase8d(dev, rel):
    """MoE at olmoe-1b-7b's full layer width on bench_moe_router.py's
    traffic (2048 tokens, skews 0 / 0.5 / 0.9, capacity factors 0.5 / 1.0 /
    1.5, both routers, 2 bounces): dropped slots and loads on the card equal
    the CPU's; the bfloat16 outputs within BF16_TOL of their scale, the
    bound phase 8a holds bfloat16 logits to (phase 8b's measured relative
    difference, ``rel``, is printed beside it)."""
    from repro_torch.configs import get
    from repro_torch.models import blocks, moe

    mcfg = get(MOE_ARCH)
    mp_dev = moe.init_moe_params(torch.Generator(device=dev).manual_seed(0), mcfg)
    mp_cpu = blocks.tree_map(lambda a: a.cpu(), mp_dev)
    rng = torch.Generator().manual_seed(0)
    base = torch.randn((1, 1, mcfg.d_model), generator=rng)
    noise = torch.randn((1, MOE_TOKENS, mcfg.d_model), generator=rng)
    tol = BF16_TOL
    rows = []
    for skew in (0.0, 0.5, 0.9):
        x = (skew * base + (1 - skew) * noise).to(torch.bfloat16)
        xd = x.to(dev)
        for capacity in (0.5, 1.0, 1.5):
            for router in ("topk", "laminar"):
                c = dataclasses.replace(mcfg, moe=dataclasses.replace(
                    mcfg.moe, router=router, capacity_factor=capacity,
                    laminar_bounces=MOE_BOUNCES))
                tag = f"[moe {router}, skew {skew}, capacity {capacity}]"
                out_d, aux_d = moe.moe_ffn(mp_dev, c, xd)
                out_c, aux_c = moe.moe_ffn(mp_cpu, c, x)
                dd, dc = int(aux_d["moe_dropped_slots"]), int(aux_c["moe_dropped_slots"])
                check(dd == dc, f"{tag} dropped {dd} != CPU {dc}")
                check(torch.equal(aux_d["moe_load"].cpu(), aux_c["moe_load"]), f"{tag} moe_load")
                err = float((out_d.cpu().float() - out_c.float()).abs().max())
                ref = float(out_c.float().abs().max())
                check(err <= tol * ref, f"{tag} output err {err} > {tol:.3g} of {ref}")
                ms = host_ms(lambda: moe.moe_ffn(mp_dev, c, xd), reps=5)
                rows.append(f"{router}/{skew}/{capacity}: dropped {dd}, err {err / ref:.2g}, "
                            f"{ms:.2f} ms")
    print(f"phase 8 (d): moe_ffn at {MOE_ARCH}'s layer width (d_model {mcfg.d_model}, "
          f"{mcfg.moe.num_experts} experts, top-{mcfg.moe.top_k}, d_ff_expert "
          f"{mcfg.moe.d_ff_expert}), {MOE_TOKENS} tokens; dropped slots and moe_load == CPU, "
          f"output within {tol:.3g} of its scale (phase 8b's model: {rel:.3g}); relative err "
          f"and card ms a call by router/skew/capacity: " + "; ".join(rows))


def phase8(dev):
    """The LM serving path on the card: (a) the model at full width, (c) the
    serve driver, (b) CUDA against CPU at 2 layers, (d) MoE at full layer
    width. Every launch counter is set to 0 before and must read 0 after."""
    from repro_torch.configs import get
    from repro_torch.models import blocks, lm

    counters = wrappers()
    for w in counters.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        cfg = get(SERVE_ARCH)
        t0 = time.perf_counter()
        params = lm.init_params(cfg, 0, dev)
        torch.cuda.synchronize()
        n_params = sum(a.numel() for a in blocks.tree_leaves(params))
        print(f"phase 8 (a): {cfg.name} at full width ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of {cfg.d_head}, "
              f"d_ff {cfg.d_ff}, vocab {cfg.vocab}): {n_params} float32 parameters drawn on the "
              f"card in {time.perf_counter() - t0:.2f} s")
        phase8a(cfg, params, dev)
        phase8c(cfg, params, dev)
        del params
        rel = phase8b(cfg, dev)
        phase8d(dev, rel)
    launched = {name: w.launches for name, w in counters.items()}
    check(not any(launched.values()), f"phase 8 launched hand-written kernels: {launched}")
    print(f"phase 8: 0 hand-written kernel launches; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# ---------------------------------------------------------------------------
# phase 9: the training path at qwen3-1.7b's full width, CUDA against CPU on
# one train step, and the RG-LRU / SSD families at full width (no
# hand-written kernel: plain PyTorch, as the reference is plain jnp)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"
TRAIN_SEQ = 4096  # train_4k's sequence length
TRAIN_BATCH = 2  # cut from train_4k's global batch of 256
TRAIN_STEPS = 6
# phases 9 (a) and 10 (a) keep qwen3-1.7b's full width (d_model, heads,
# vocab), seq 4096 and batch 2, and cut its 28 layers to TRAIN_LAYERS, to
# keep the whole script within 60 % of its time limit (at 28 layers the two
# took 319 s, the checkpoints 20.6 GB each; at 4, 82 s on a slow host)
TRAIN_LAYERS = 2
# tests/test_train.py checkpoints every 2 steps; every 4 keeps the run's disk
# writes to one checkpoint, and the restart still resumes at step 4
CKPT_EVERY = 4
RESTART_STEPS = 7  # tests/test_train.py's restart: 6 steps, then 7 from the newest checkpoint
RESTART_WANT = 3  # resumed at step 4, ran 4, 5, 6
LOSS_RTOL = 1e-6  # tests/test_torch_train.py's float32 bounds (CPU against JAX)
GNORM_RTOL = 1e-5
STEP_PARAM_LR_TOL = 0.25
FAMILIES = (("mamba2-130m", 2048), ("recurrentgemma-2b", 1024))  # (arch, train seq)


def profile_step(fn, label, steps=1):
    """aten ops, device kernels and device busy share of ``fn`` (after one
    warm-up call), torch.profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    dev_us, dev_n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[e.name] = dev_us.get(e.name, 0.0) + e.time_range.elapsed_us()
            dev_n += 1
    n_ops = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    busy = sum(dev_us.values()) / 1e6 / steps
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
    print(f"{label}: {wall * 1e3:.1f} ms wall, {n_ops / steps:.0f} aten ops (nested ones "
          f"included) and {dev_n / steps:.0f} device kernels, device busy "
          f"{busy * 1e3:.1f} ms = {busy / wall:.1%} of wall; largest: "
          + "; ".join(f"{us / steps / 1e3:.2f} ms {name[:50]}" for name, us in top))
    return {"wall_ms": wall * 1e3, "aten_ops": n_ops / steps, "kernels": dev_n / steps,
            "busy": busy / wall}


def train_config():
    """qwen3-1.7b at full width, its depth cut to TRAIN_LAYERS."""
    from repro_torch.configs import get

    return dataclasses.replace(get(TRAIN_ARCH), n_layers=TRAIN_LAYERS)


def phase9a(dev, ckpt_dir):
    """The train driver's path (``launch.train.run``: ``make_pipeline`` and
    ``Trainer``) at qwen3-1.7b's full width cut to TRAIN_LAYERS layers: 6
    steps with a checkpoint every ``CKPT_EVERY``, then a restart from the
    newest checkpoint; a profiled step."""
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.train import data, optimizer

    cfg = train_config()
    check(cfg.remat == "block" and cfg.compute_dtype == torch.bfloat16, f"{cfg.name} config")
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=str(ckpt_dir), ckpt_every=CKPT_EVERY,
              device=dev.type)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.run(cfg, steps=TRAIN_STEPS, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses, secs = out["losses"], out["step_seconds"]
    check(out["steps"] == TRAIN_STEPS and np.isfinite(losses).all(), f"[train] losses {losses}")
    ms = float(np.median(secs[2:6])) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 9 (a): launch.train.run (the compiled step) at {cfg.name}'s full width "
          f"cut to {cfg.n_layers} "
          f"layers (of 28; d_model {cfg.d_model}, vocab {cfg.vocab}, float32 parameters, "
          f"bfloat16 compute, remat {cfg.remat!r}), "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ} (train_4k's length; its global batch 256 cut "
          f"to {TRAIN_BATCH}), {TRAIN_STEPS} steps, a checkpoint every {CKPT_EVERY}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step seconds "
          f"{', '.join(f'{x:.3f}' for x in secs)}; {ms:.1f} ms a step at {cfg.n_layers} layers "
          f"(median of steps 2-5, host clock ending in a synchronize) = "
          f"{tokens / ms * 1e3:.0f} tokens/s; max_memory_allocated {peak:.2f} GiB; {wall:.1f} s "
          f"wall with the checkpoints")
    t0 = time.perf_counter()
    again = train.run(cfg, steps=RESTART_STEPS, **kw)
    print(f"phase 9 (a): restart at {cfg.n_layers} layers with steps={RESTART_STEPS} from the "
          f"newest checkpoint: "
          f"{again['steps']} steps (the reference's count: {RESTART_WANT}), losses "
          f"{', '.join(f'{x:.4f}' for x in again['losses'])}; {time.perf_counter() - t0:.1f} s "
          f"wall with the restore")
    check(again["steps"] == RESTART_WANT and np.isfinite(again["losses"]).all(),
          f"[restart] ran {again['steps']} steps, want {RESTART_WANT}")

    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    params = lm.init_params(cfg, 0, dev)
    state = optimizer.init_opt_state(ocfg, params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             next(data.make_pipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)).items()}
    step = steps.make_train_step(cfg, ocfg)
    prof = profile_step(lambda: step(params, state, batch)[2]["loss"].item(),
                        f"phase 9 (a): profiled eager train step ({cfg.n_layers} layers)")
    return {"losses": losses, "restart_losses": again["losses"], "ms": ms,
            "tokens_s": tokens / ms * 1e3, "peak": peak, "profile": prof}


def phase9b(dev):
    """qwen3-1.7b's full width cut to 2 layers: one train step on the card
    and on the CPU with the same parameters (carried by the bridge) and
    batch, float32 and bfloat16 compute; decode after prefill against
    forward at S = 2048 in bfloat16 (``scripts/torch_decode_gap.py``
    measures the reference's on the CPU: 0.0234375)."""
    from repro_torch.configs import get
    from repro_torch.launch import steps
    from repro_torch.models import bridge, lm
    from repro_torch.train import data, optimizer

    base = get(TRAIN_ARCH).scaled(n_layers=2)
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    p_np = bridge.params_to_numpy(lm.init_params(base, 0, "cpu"))
    b = next(data.make_pipeline(base.vocab, 1, 256, seed=0))
    for cd in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, compute_dtype=cd)
        out = {}
        for d in ("cpu", dev):
            p = bridge.params_from_numpy(p_np, d)
            st = optimizer.init_opt_state(ocfg, p)
            p, st, m = steps.make_train_step(cfg, ocfg)(
                p, st, {k: torch.from_numpy(v).to(d) for k, v in b.items()})
            out[str(d)] = (p, m)
        (pc, mc), (pd, md) = out["cpu"], out[str(dev)]
        lc, ld = float(mc["loss"]), float(md["loss"])
        tag = f"[2 layers, {str(cd).removeprefix('torch.')} compute]"
        gap = abs(ld - lc) / abs(lc)
        check(np.isfinite(ld) and float(md["lr"]) == float(mc["lr"]), f"{tag} loss / lr")
        if cd == torch.float32:
            gn = abs(float(md["grad_norm"]) - float(mc["grad_norm"])) / float(mc["grad_norm"])
            dp = max(float((a - c.cpu()).abs().max())
                     for a, c in zip(optimizer.sorted_leaves(pc), optimizer.sorted_leaves(pd)))
            print(f"phase 9 (b) {tag}: one train step (batch 1 x seq 256), CUDA vs CPU: loss "
                  f"{ld:.7f} vs {lc:.7f} ({gap:.3g} of it), grad_norm {gn:.3g} of it, lr equal, "
                  f"parameters within {dp / ocfg.lr:.3g} lr")
            check(gap <= LOSS_RTOL and gn <= GNORM_RTOL and dp <= STEP_PARAM_LR_TOL * ocfg.lr,
                  f"{tag} CUDA differs from CPU")
        else:
            print(f"phase 9 (b) {tag}: loss {ld:.6f} vs {lc:.6f} ({gap:.3g} of it)")
            check(gap <= BF16_TOL, f"{tag} loss differs by {gap:.3g}")
        del out, pc, pd
    cfg = base
    with torch.inference_mode():
        params = bridge.params_from_numpy(p_np, dev)
        err, scale, outside, _, _ = decode_vs_forward(cfg, params, LONG_PROMPT, 1, dev)
    print(f"phase 9 (b): 2 layers, bfloat16, S = {LONG_PROMPT}: decode after prefill vs "
          f"forward's last logits on the card: max abs {err:.6g} at logit scale {scale:.6g}, "
          f"{outside} past rtol = atol = {DECODE_TOL}")
    check(err <= BF16_TOL * scale, f"[2 layers, S={LONG_PROMPT}] decode gap {err}")


def phase9c(dev):
    """mamba2-130m and recurrentgemma-2b at full width: forward at S = 2048,
    decode after prefill against forward's last logits (float32 and
    bfloat16, as phase 8a holds qwen3), one train step; ms and peak
    memory."""
    from repro_torch.configs import get
    from repro_torch.launch import steps
    from repro_torch.models import blocks, lm
    from repro_torch.train import data, optimizer

    for arch, train_seq in FAMILIES:
        cfg = get(arch)
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(cfg, 0, dev)
        n = sum(a.numel() for a in blocks.tree_leaves(params))
        with torch.inference_mode():
            for cd in (torch.float32, torch.bfloat16):
                c = dataclasses.replace(cfg, compute_dtype=cd)
                err, scale, outside, pf_ms, fwd_ms = decode_vs_forward(c, params, LONG_PROMPT, 1,
                                                                        dev)
                tag = f"[{arch}, S={LONG_PROMPT}, {str(cd).removeprefix('torch.')} compute]"
                print(f"phase 9 (c) {tag}: decode after prefill against forward's last logits: "
                      f"max abs err {err:.4g} at logit scale {scale:.4g}, {outside} outside "
                      f"rtol = atol = {DECODE_TOL}")
                if cd == torch.bfloat16:
                    check(err <= BF16_TOL * scale, f"{tag} decode differs from forward by {err}")
                else:
                    check(outside == 0, f"{tag} decode differs from forward by {err}")
            tok = torch.randint(0, cfg.vocab, (1, LONG_PROMPT), device=dev)
            fwd = host_ms(lambda: lm.forward(cfg, params, tok), reps=3)
            caches = lm.init_cache(cfg, 1, LONG_PROMPT + 4, dev)
            _, caches = lm.prefill(cfg, params, tok[:, :-1], caches)
            dec = host_ms(lambda: lm.decode_step(cfg, params, tok[:, -1:], LONG_PROMPT - 1,
                                                 caches), reps=5)
            del caches
        infer_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        state = optimizer.init_opt_state(ocfg, params)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 next(data.make_pipeline(cfg.vocab, 1, train_seq, seed=0)).items()}
        step = steps.make_train_step(cfg, ocfg)
        losses = [step(params, state, batch)[2]["loss"].item()]
        train_ms = host_ms(lambda: losses.append(step(params, state, batch)[2]["loss"].item()),
                           reps=2)
        check(np.isfinite(losses).all(), f"[{arch}] train losses {losses}")
        print(f"phase 9 (c): {arch} at full width ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {n} float32 parameters, bfloat16 compute): forward of "
              f"{LONG_PROMPT} tokens {fwd:.1f} ms, decode step {dec:.2f} ms, peak "
              f"{infer_peak:.2f} GiB; train step at batch 1 x seq {train_seq} (train_4k's "
              f"4096 and batch 256 cut) {train_ms:.1f} ms, losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del params, state, step, batch


def train_steps(step, params, state, batches):
    """``step`` over ``batches`` from ``params`` / ``state``: each step's
    metrics (host values) and seconds (host clock ending in reading the
    loss), the final state's leaves, and the allocated and reserved peaks
    (GiB) from a reset before the first step."""
    from repro_torch.train import optimizer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, secs = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        loss = m["loss"].item()
        secs.append(time.perf_counter() - t0)
        metrics.append({"loss": loss, "grad_norm": m["grad_norm"].item(),
                        "lr": m["lr"].item(), "dropped": int(m["moe_dropped_slots"])})
    return {"metrics": metrics, "secs": secs, "params": optimizer.sorted_leaves(params),
            "state": (params, state),
            "alloc": torch.cuda.max_memory_allocated() / 2**30,
            "reserved": torch.cuda.max_memory_reserved() / 2**30}


def train_gaps(a, b, lr):
    """Largest loss and grad-norm gaps (relative) and parameter gap (in lr)
    of two runs of :func:`train_steps`; whether they are bit-equal."""
    loss = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
               for x, y in zip(a["metrics"], b["metrics"]))
    gnorm = max(abs(x["grad_norm"] - y["grad_norm"]) / y["grad_norm"]
                for x, y in zip(a["metrics"], b["metrics"]))
    par = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a["params"], b["params"]))
    equal = a["metrics"] == b["metrics"] and all(
        torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    return {"loss": loss, "gnorm": gnorm, "params_lr": par / lr, "equal": equal}


def phase9d(dev, base):
    """The compiled train step (``launch.steps.CompiledTrainStep``: a
    warm-up step, the capture, then replays) against eager
    ``make_train_step`` at phase 9 (a)'s config (qwen3-1.7b's full width, 2
    layers, batch 2 x seq 4096), the same init and batches: eager twice
    (their own gap), captured once; the loss, grad-norm and final-parameter
    gaps, ms a step (median of steps 2-5), tokens/s, allocated and reserved
    peaks; the replay's host enqueue ms, a profiled replay's device busy
    share beside 9 (a)'s eager one, and the graph's nodes."""
    from repro_torch.kernel_bench import graph_census, tick_entries
    from repro_torch.launch import steps
    from repro_torch.models import blocks, lm
    from repro_torch.train import data, optimizer

    cfg = train_config()
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    it = data.make_pipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
               for _ in range(TRAIN_STEPS)]
    init = lm.init_params(cfg, 0, dev)

    def fresh():
        p = blocks.tree_map(torch.clone, init)
        return p, optimizer.init_opt_state(ocfg, p)

    eager, step = steps.make_train_step(cfg, ocfg), steps.CompiledTrainStep(cfg, ocfg)
    runs = {}
    for tag in ("eager", "eager again", "captured"):
        runs[tag] = train_steps(step if tag == "captured" else eager, *fresh(), batches)
        if tag != "captured":
            del runs[tag]["state"]
            torch.cuda.empty_cache()
    e, e2, c = runs["eager"], runs["eager again"], runs["captured"]
    losses = ", ".join(f"{m['loss']:.6f}" for m in c["metrics"])
    ee, ce = train_gaps(e2, e, ocfg.lr), train_gaps(c, e, ocfg.lr)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms = {tag: float(np.median(r["secs"][2:6])) * 1e3 for tag, r in runs.items()}
    check(step.builds == 1 and step.graph is not None, "[9 (d)] the step was not captured once")

    def gaps(g):
        return ("bit-equal" if g["equal"] else
                f"loss {g['loss']:.3g}, grad norm {g['gnorm']:.3g} of themselves, parameters "
                f"{g['params_lr']:.3g} lr")

    print(f"phase 9 (d): the compiled train step (CompiledTrainStep: step 0 eager as the "
          f"warm-up, then the capture; steps 1-{TRAIN_STEPS - 1} replays) at {cfg.name}'s full "
          f"width, {cfg.n_layers} layers, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} "
          f"steps from one init: captured against eager {gaps(ce)}; eager against eager "
          f"{gaps(ee)}; losses {losses}")
    for tag, r in runs.items():
        print(f"phase 9 (d) [{tag}]: step seconds {', '.join(f'{x:.4f}' for x in r['secs'])}; "
              f"{ms[tag]:.2f} ms a step (median of steps 2-5) = {tokens / ms[tag] * 1e3:.0f} "
              f"tokens/s; max_memory_allocated {r['alloc']:.2f} GiB, max_memory_reserved "
              f"{r['reserved']:.2f} GiB")
    check(ce["equal"] or (ce["loss"] <= LOSS_RTOL and ce["gnorm"] <= GNORM_RTOL
                          and ce["params_lr"] <= STEP_PARAM_LR_TOL),
          f"[9 (d)] captured differs from eager: {ce} (eager against eager: {ee})")

    params, state = c.pop("state")
    b = batches[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, state, b)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    finished = time.perf_counter() - t0
    prof = profile_step(lambda: step(params, state, b)[2]["loss"].item(),
                        f"phase 9 (d): profiled replayed train step ({cfg.n_layers} layers)")
    census = graph_census(step.graph)
    hand = tick_entries(census["names"])
    print(f"phase 9 (d): a replay {finished * 1e3:.2f} ms to its end, host enqueue "
          f"{enqueue * 1e3:.3f} ms (batch copy and replay); device busy {prof['busy']:.1%} "
          f"of the profiled wall (eager, 9 (a): {base['profile']['busy']:.1%} of "
          f"{base['profile']['wall_ms']:.1f} ms); graph nodes: {census['kernel']} kernel "
          f"(hand-written: {hand or 'none'}), {census['memcpy']} memcpy "
          f"({census['host_memcpy']} touching host memory), {census['memset']} memset, "
          f"{census['other']} other")
    check(census["host_memcpy"] == 0 and not hand and census["kernel"] > 0,
          f"[9 (d)] the train step's graph: {census}")
    return {"ms": ms, "gaps": ce, "eager_gaps": ee, "profile": prof}


def phase9(dev):
    """The training path and the new families on the card; every launch
    counter is set to 0 before and must read 0 after."""
    counters = wrappers()
    for w in counters.values():
        w.launches = 0
    (ROOT / "build").mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
        for part, run in (("a", lambda: phase9a(dev, ckpt_dir)),
                          ("d", lambda: phase9d(dev, out["a"])), ("b", lambda: phase9b(dev)),
                          ("c", lambda: phase9c(dev))):
            t1 = time.perf_counter()
            out[part] = run()
            torch.cuda.empty_cache()
            print(f"phase 9 ({part}): {time.perf_counter() - t1:.1f} s wall")
    launched = {name: w.launches for name, w in counters.items()}
    check(not any(launched.values()), f"phase 9 launched hand-written kernels: {launched}")
    print("phase 9: 0 hand-written kernel launches")
    return out["a"]


# phase 10 (b): the dry-run and the roofline, in a CPU process of their own
# (no card: the fake process group and fake tensors trace every rank's
# shapes); one JSON line out
DRYRUN_CODE = """
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from repro_torch.configs import get
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import fake_process_group, make_mesh
arch, batch, layers = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
out = {"cells": [dryrun.run_cell(arch, "train_4k", mp, verbose=False) for mp in (False, True)]}
s = SHAPES["train_4k"]
with fake_process_group(1):
    out["roofline"] = roofline.analyze(dataclasses.replace(get(arch), n_layers=layers),
                                       ShapeSpec(s.name, s.seq_len, batch, s.kind),
                                       make_mesh((1, 1), ("data", "model"), "cpu"))
print(json.dumps(out))
"""
DRYRUN_TIMEOUT_S = 600


def start_dryrun():
    """Phase 10 (b)'s process, started to run beside phase 10 (a)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CODE, str(SRC), TRAIN_ARCH, str(TRAIN_BATCH),
         str(TRAIN_LAYERS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def phase10a(dev, ckpt_dir, base):
    """The train driver with phase 9a's own arguments plus ``--mesh 1x1``:
    a ``DeviceMesh("cuda", (1, 1))`` over the one-rank NCCL group, the
    parameters, moments and batches DTensors placed by the sharding rules;
    the losses against 9a's, a restart, ms a step, peak memory and a
    profiled step beside 9a's."""
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    from repro_torch.train import data, optimizer

    cfg = train_config()
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=str(ckpt_dir), ckpt_every=CKPT_EVERY,
              device=dev.type, mesh="1x1")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.run(cfg, steps=TRAIN_STEPS, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses, secs = out["losses"], out["step_seconds"]
    check(out["steps"] == TRAIN_STEPS and np.isfinite(losses).all(), f"[mesh] losses {losses}")
    equal = np.array_equal(losses, base["losses"])
    gap = float(np.max(np.abs(losses - base["losses"]) / np.abs(base["losses"])))
    ms = float(np.median(secs[2:6])) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 10 (a): launch.train.run with mesh 1x1 at {cfg.name}'s full width cut to "
          f"{cfg.n_layers} layers, phase 9 (a)'s arguments: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}: "
          + ("bit-equal to phase 9 (a)'s" if equal else
             f"NOT bit-equal to phase 9 (a)'s (largest gap {gap:.3g} of the loss)")
          + f"; step seconds {', '.join(f'{x:.3f}' for x in secs)}; {ms:.1f} ms a step "
          f"(9 (a): {base['ms']:.1f}) = {tokens / ms * 1e3:.0f} tokens/s (9 (a): "
          f"{base['tokens_s']:.0f}); max_memory_allocated {peak:.2f} GiB (9 (a): "
          f"{base['peak']:.2f}); {wall:.1f} s wall with the checkpoints")
    check(equal or gap <= LOSS_RTOL, f"[mesh] losses differ from phase 9 (a)'s by {gap:.3g}")
    t0 = time.perf_counter()
    again = train.run(cfg, steps=RESTART_STEPS, **kw)
    same = np.array_equal(again["losses"], base["restart_losses"])
    print(f"phase 10 (a): restart at {cfg.n_layers} layers with steps={RESTART_STEPS} from the "
          f"newest checkpoint: "
          f"{again['steps']} steps, losses {', '.join(f'{x:.4f}' for x in again['losses'])} "
          f"({'bit-equal to' if same else 'NOT equal to'} phase 9 (a)'s restart); "
          f"{time.perf_counter() - t0:.1f} s wall with the restore")
    check(again["steps"] == RESTART_WANT and np.isfinite(again["losses"]).all(),
          f"[mesh restart] ran {again['steps']} steps, want {RESTART_WANT}")

    mesh = make_mesh((1, 1), ("data", "model"), dev.type)
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    params = lm.init_params(cfg, 0, dev)
    specs = sharding.tree_param_specs(mesh, params)
    state = optimizer.init_opt_state(ocfg, params)
    params = sharding.distribute(mesh, params, specs)
    state = optimizer.AdamState(step=sharding.distribute(mesh, state.step, ()),
                                mu=sharding.distribute(mesh, state.mu, specs),
                                nu=sharding.distribute(mesh, state.nu, specs), err=None)
    batch = sharding.distribute(mesh, {
        k: torch.from_numpy(v).to(dev) for k, v in
        next(data.make_pipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)).items()},
        sharding.tokens_spec(mesh))
    step = steps.make_train_step(cfg, ocfg)

    prof = profile_step(lambda: step(params, state, batch)[2]["loss"].full_tensor().item(),
                        f"phase 10 (a): profiled train step on the 1x1 mesh ({cfg.n_layers} "
                        f"layers)")
    base_ops = base["profile"]["aten_ops"]
    print(f"phase 10 (a): DTensor's cost on the 1x1 step: {prof['aten_ops']:.0f} aten ops "
          f"(9 (a): {base_ops:.0f}, x{prof['aten_ops'] / base_ops:.3f}), "
          f"{prof['wall_ms']:.1f} ms profiled wall (9 (a): {base['profile']['wall_ms']:.1f}), "
          f"device busy {prof['busy']:.1%} (9 (a): {base['profile']['busy']:.1%})")


def phase10b(proc, base):
    """Phase 10 (b)'s results: qwen3-1.7b x train_4k on the (16, 16) and
    (2, 16, 16) production meshes (per device), the roofline at phase 9
    (a)'s shape on (1, 1) beside 9 (a)'s measured ms a step."""
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0, f"phase 10 (b): the dry-run process failed:\n{stderr[-3000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    for rec in out["cells"]:
        check(rec["status"] == "ok", f"phase 10 (b): dry-run cell {rec}")
        c, m, coll = rec["cost"], rec["memory"], rec["collectives"]
        kinds = ", ".join(f"{k} {v:.4g}" for k, v in coll.items()
                          if k not in ("count", "total_bytes"))
        print(f"phase 10 (b): dry-run {rec['arch']} x {rec['shape']} on the "
              f"{'multi' if rec['multi_pod'] else 'single'}-pod mesh ({rec['devices']} devices, "
              f"traced in {rec['compile_s']} s on the host CPU), per device: {c['flops']:.4g} "
              f"FLOPs, {c['bytes_accessed']:.4g} bytes accessed (unfused), "
              f"{c['transcendentals']:.4g} transcendentals; collectives {kinds} "
              f"({coll['count']} calls, {coll['total_bytes']:.4g} bytes); argument "
              f"{m['argument_bytes'] / 2**30:.3f} GiB, output {m['output_bytes'] / 2**30:.3f} "
              f"GiB, temp {m['temp_bytes'] / 2**30:.3f} GiB")
    r = out["roofline"]
    check(r["status"] == "ok", f"phase 10 (b): roofline {r}")
    bound_s = max(r["compute_s"], r["memory_s"], r["collective_s"])
    measured_s = base["ms"] / 1e3
    print(f"phase 10 (b): H100 roofline of {r['arch']} at phase 9 (a)'s shape ({TRAIN_LAYERS} "
          f"layers, seq {TRAIN_SEQ}, batch {TRAIN_BATCH}) on a (1, 1) mesh: compute "
          f"{r['compute_s'] * 1e3:.1f} ms ({r['flops_per_device']:.4g} FLOPs at 989 TFLOP/s "
          f"bf16), memory {r['memory_s'] * 1e3:.1f} ms ({r['bytes_per_device']:.4g} unfused "
          f"bytes at 3.35 TB/s), collective {r['collective_s'] * 1e3:.3f} ms; dominant "
          f"{r['dominant']}; roofline fraction {r['roofline_fraction']:.3f} (model FLOPs "
          f"{r['model_flops_global']:.4g}, useful ratio {r['useful_flops_ratio']:.3f}); "
          f"measured {base['ms']:.1f} ms a step in 9 (a): the bound is "
          f"{bound_s / measured_s:.1%} of it")


def phase10(dev, base):
    """The mesh-aware trainer and the dry-run / roofline; every launch
    counter is set to 0 before and must read 0 after."""
    counters = wrappers()
    for w in counters.values():
        w.launches = 0
    proc = start_dryrun()
    try:
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
            phase10a(dev, ckpt_dir, base)
        torch.cuda.empty_cache()
        print(f"phase 10 (a): {time.perf_counter() - t1:.1f} s wall")
        t1 = time.perf_counter()
        phase10b(proc, base)
        print(f"phase 10 (b): {time.perf_counter() - t1:.1f} s wall after (a)")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    launched = {name: w.launches for name, w in counters.items()}
    check(not any(launched.values()), f"phase 10 launched hand-written kernels: {launched}")
    print("phase 10: 0 hand-written kernel launches")


# ---------------------------------------------------------------------------
# phase 11: the lockstep engine (run_batch), one batched launch a tick
# ---------------------------------------------------------------------------


def int_differences(a, b):
    """The integer metrics and timeseries on which two summaries differ."""
    diff = [k for k, v in a.items() if isinstance(v, int) and v != b[k]]
    diff += [f for f in a["timeseries"]
             if not np.array_equal(a["timeseries"][f], b["timeseries"][f])]
    if not np.array_equal(a["lat_hist"], b["lat_hist"]):
        diff.append("lat_hist")
    return diff


def lockstep(eng, seeds, generator_device=None):
    """``init_batch`` of ``seeds`` and their draws (each seed its own
    generator, on ``generator_device`` if given): (state, draws, lam)."""
    from repro_torch.core.draws import BatchDraws, TorchDraws

    sb, lam = eng.init_batch(seeds)
    Z = sb.zstart.shape[1]
    draws = BatchDraws([TorchDraws(eng.cfg, lam, Z, seed=sd, device=eng.device,
                                   generator_device=generator_device) for sd in seeds])
    return sb, draws, lam


def phase11a(dev, totals):
    """Lockstep against sequential on the card, the launches and syncs;
    returns (the lockstep launches, lockstep and sequential seed-ticks/s)."""
    from repro_torch.core.engine import LaminarEngine, seed_state
    from repro_torch.kernels import LOCKSTEP
    from repro_torch.profile_tick import exp5_config

    cfg = exp5_config(True, full=True, ticks=BATCH_TICKS)
    eng = LaminarEngine(cfg, device=dev)
    B, T = len(BATCH_SEEDS), BATCH_TICKS
    sb, draws, lam = lockstep(eng, BATCH_SEEDS)
    (final, ts), launches, syncs, wall, _ = counted(lambda: eng.simulate_batch(sb, draws, T))
    check(ts.shape == (B, T, 11), f"[lockstep] timeseries shape {tuple(ts.shape)}")
    want = {name: 0 for name in launches}
    want.update(dict.fromkeys(LOCKSTEP, T))
    check(launches == want, f"[lockstep] launch counts {launches} != {want}")
    check(syncs == 0, f"[lockstep] {syncs} host syncs inside the ticks")
    add(totals, launches)
    ts = ts.cpu().numpy()
    outs = [eng._summary(seed_state(final, i), ts[i], lam, sd) for i, sd in enumerate(BATCH_SEEDS)]
    for out in outs:
        check_run(f"lockstep seed {out['seed']}", out, launches, want, syncs)
        check(out["suspended_cnt"] > 0, f"[lockstep seed {out['seed']}] Airlock did not act")
    # each seed alone, from the same init_batch slice and generator
    sb0, _ = eng.init_batch(BATCH_SEEDS)
    seq_wall = 0.0
    for i, sd in enumerate(BATCH_SEEDS):
        draws = eng.draws(lam, sb0.zstart.shape[1], sd)
        (f, t_i), l_i, sy_i, w_i, _ = counted(
            lambda: eng.simulate(seed_state(sb0, i), draws, T))
        seq_wall += w_i
        check(sy_i == 0 and l_i == want_launches(cfg, T, sharded=False),
              f"[sequential seed {sd}] launches {l_i}, {sy_i} syncs")
        seq = eng._summary(f, t_i.cpu().numpy(), lam, sd)
        diff = int_differences(seq, outs[i])
        check(not diff, f"[seed {sd}] lockstep and sequential differ in {diff}")
    lock_tps, seq_tps = B * T / wall, B * T / seq_wall
    print(f"phase 11 (a): Exp5 at {cfg.num_nodes} nodes / {cfg.probe_capacity} slots, Airlock "
          f"on, seeds {BATCH_SEEDS}, {T} ticks: lockstep == sequential on the card on every "
          f"integer metric, lat_hist and timeseries, seed by seed (started "
          f"{[o['started'] for o in outs]}, suspended {[o['suspended_cnt'] for o in outs]}); "
          f"lockstep launches {dict((k, v) for k, v in launches.items() if v)} (each entry "
          f"once a tick for all {B} seeds), {syncs} host syncs in the ticks; "
          f"from init: {lock_tps:.1f} seed-ticks/s lockstep, {seq_tps:.1f} sequential")
    return launches


def phase11b(dev):
    """The lockstep run on the card against the CPU's at phase 4's geometry,
    on one CPU generator's draws."""
    from repro_torch.core.engine import LaminarEngine, seed_state
    from repro_torch.profile_tick import exp5_config

    cfg = exp5_config(True, full=False, ticks=BATCH_TICKS)
    outs = []
    for device in ("cpu", dev):
        eng = LaminarEngine(cfg, device=device)
        sb, draws, lam = lockstep(eng, BATCH_SEEDS, generator_device="cpu")
        final, ts = eng.simulate_batch(sb, draws, BATCH_TICKS)
        ts = ts.cpu().numpy()
        outs.append([eng._summary(seed_state(final, i), ts[i], lam, sd)
                     for i, sd in enumerate(BATCH_SEEDS)])
    for cpu, gpu in zip(*outs):
        diff = int_differences(cpu, gpu)
        check(not diff, f"[lockstep seed {cpu['seed']}] CPU and CUDA differ in {diff}")
        check(cpu["started"] > 0, "degenerate lockstep parity run")
    print(f"phase 11 (b): lockstep at {cfg.num_nodes} nodes, seeds {BATCH_SEEDS}, "
          f"{BATCH_TICKS} ticks, one CPU generator's draws a seed: CPU == CUDA on every "
          f"integer metric, lat_hist and timeseries, seed by seed (started "
          f"{[o['started'] for o in outs[0]]})")


def phase11c(dev, rows, launches):
    """Each entry of the lockstep tick given the seed axis, on the lockstep
    tick 200's inputs, against its plain version seed by seed, timed, in
    guard bands; the timings go into the entry's table row."""
    from repro_torch.kernels import ENTRIES, LOCKSTEP
    from repro_torch.kernels.batching import per_seed
    from repro_torch.kernels.bitmap_fit import bitmap_fit_rounds_ref
    from repro_torch.kernels.bitmap_fit import ops as bitmap_ops
    from repro_torch.kernels.node_view import node_view_ref
    from repro_torch.kernels.survival_scan import ops as surv_ops
    from repro_torch.kernels.survival_scan import survival_scan_ref
    from repro_torch.kernels.utility_topk import utility_topk_address_ref
    from repro_torch.kernels.zone_aggregate import zone_aggregate_members_ref
    from repro_torch.profile_tick import (
        WARMUP_TICKS,
        batch_tick_calls,
        exp5_config,
        per_seed_calls,
    )

    refs = {name: per_seed(ref) for name, ref in (
        ("bitmap_fit_rounds", bitmap_fit_rounds_ref),
        ("utility_topk_address", utility_topk_address_ref),
        ("zone_aggregate_members", zone_aggregate_members_ref),
        ("survival_scan", survival_scan_ref), ("node_view", node_view_ref))}
    cfg = exp5_config(True, full=True)
    B = len(BATCH_SEEDS)
    calls = batch_tick_calls(cfg, BATCH_SEEDS, WARMUP_TICKS, 1, LOCKSTEP, device=dev)
    per = {}
    for name in LOCKSTEP:
        wrapper = ENTRIES[name].wrapper
        ((args, kw, _),) = calls[name]
        case = (tuple(a.cpu() for a in args), kw, None, None)
        err, want = check_kernel(name, wrapper, refs[name], case, dev)
        per[name] = (case, want)
        seeds = per_seed_calls([(case[0], kw, want)])
        work_s = [work(name, (a, k, None, None), w) for a, k, w in seeds]
        nbytes, nops = sum(w[0] for w in work_s), sum(w[1] for w in work_s)
        dargs = to_dev(case[0], dev)
        ms = device_ms(lambda: wrapper(*dargs, **kw))
        plain_ms = device_ms(lambda: refs[name](*dargs, **kw))
        one_ms = device_ms(lambda: [wrapper(*(a[i] for a in dargs), **kw) for i in range(B)])
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_OPS_PER_S * 1e3
        rows[name]["seed_axis"] = axis = dict(
            seeds=B, launches=launches[name], max_abs_err=err, ms=ms, per_seed_ms=one_ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        )
        print(f"phase 11 (c): {name} (B = {B}, lockstep tick {WARMUP_TICKS}): equal to the "
              f"plain version seed by seed (max abs err {err:.3g}); device time: one launch "
              f"with the seed axis {ms:.6f} ms, {B} launches without {one_ms:.6f} ms, plain "
              f"{plain_ms:.6f} ms, bound {axis['bound_ms']:.7f} ms ({axis['bound_by']})")
    guard_bands(dev, "lockstep tick", per)
    # each seed's scratch as the sources lay it out
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitmap_fit import plan as bitmap_plan
    from repro_torch.kernels.survival_scan import plan as surv_plan

    P, N = cfg.probe_capacity, cfg.num_nodes
    stride = _build.load("survival_scan", {"survival_scan_scratch_stride": [ctypes.c_int] * 2}
                         ).survival_scan_scratch_stride(P, N)
    keys = _build.load("bitmap_fit", {"bitmap_fit_rounds_scratch_words": [ctypes.c_int] * 2}
                       ).bitmap_fit_rounds_scratch_words(N, cfg.arb_rounds)
    for name, words in (("survival_scan", B * stride), ("bitmap_fit_rounds", B * keys)):
        case = per[name][0]
        got = ENTRIES[name].plan(*case[0], **case[1]).scratch_words
        check(got == words, f"{name}: plan scratch {got} words, the source lays out {words}")

    resident = {
        "survival_scan": surv_ops.cluster_occupancy(
            surv_plan.plan(cfg.probe_capacity, cfg.num_nodes, True))["clusters"],
        "bitmap_fit_rounds": bitmap_ops.rounds_cluster_occupancy(bitmap_plan.rounds_plan(
            cfg.probe_capacity, cfg.num_nodes, cfg.atoms_per_node // 32, cfg.arb_rounds,
            cfg.atoms_per_node))["clusters"]}
    print(f"phase 11 (c): every entry's outputs with the seed axis fully written under its "
          f"plan, guard bands untouched, scratch strides as the sources'; 16-CTA clusters the "
          f"card holds at once (a batch past them runs in waves): {resident}")


def phase11d(dev):
    """Seed-ticks/s of lockstep B = 1, 4, 8 and sequential B = 4 at steady
    state (after BATCH_WARMUP ticks), and one profiled batched tick at B = 8."""
    from repro_torch.core.engine import LaminarEngine, make_step
    from repro_torch.profile_tick import WARMUP_TICKS, batch_ticker, exp5_config, window

    cfg = exp5_config(True, full=True)

    def rate(advance, seeds):
        advance(BATCH_WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance(BATCH_TIMED)
        torch.cuda.synchronize()
        return seeds * BATCH_TIMED / (time.perf_counter() - t0)

    tps = {B: rate(batch_ticker(cfg, list(range(B)), dev), B) for B in BATCH_SIZES}
    eng = LaminarEngine(cfg, device=dev)
    s, lam = eng.init(0)
    draws = eng.draws(lam, s.zstart.shape[0], 0)
    step = make_step(cfg)
    state = {"s": s, "t": 0}

    def advance(n):  # one seed's run: sequential B seeds take B times as long
        for _ in range(n):
            state["s"], _ = step(state["s"], draws.tick(state["t"]))
            state["t"] += 1

    seq = rate(advance, 1)
    print(f"phase 11 (d): Exp5, Airlock on, ticks {BATCH_WARMUP} to "
          f"{BATCH_WARMUP + BATCH_TIMED - 1} (host clock to the device's end): lockstep "
          f"seed-ticks/s " + ", ".join(f"B = {B} {tps[B]:.1f}" for B in BATCH_SIZES)
          + f"; sequential (any B) {seq:.1f}")
    B = max(BATCH_SIZES)
    advance = batch_ticker(cfg, list(range(B)), dev)
    advance(WARMUP_TICKS)
    torch.cuda.synchronize()
    w = window(advance, 1)
    busy = ("not measured (no device events)" if w["busy_ms"] is None else
            f"{w['busy_ms']:.3f} ms = {w['busy_ms'] / w['wall_ms']:.1%} of wall")
    hand = ", ".join(f"{k} {c:.0f} x {us:.1f} us" for k, (c, us) in w["hand_written"].items() if c)
    print(f"phase 11 (d): one profiled lockstep tick at B = {B} (tick {WARMUP_TICKS}): "
          f"{w['wall_ms']:.3f} ms host wall, {w['aten_ops']:.0f} aten ops (nested ones "
          f"included), {w['kernels']:.0f} device kernels, device busy {busy}; hand-written: "
          f"{hand}")
    return tps


def phase11(dev, totals, rows):
    """Returns 11 (d)'s eager lockstep seed-ticks/s by B."""
    launches = phase11a(dev, totals)
    phase11b(dev)
    phase11c(dev, rows, launches)
    return phase11d(dev)


# ---------------------------------------------------------------------------
# phase 12: the compiled run (core.scan), against make_step driven by hand
# ---------------------------------------------------------------------------


def lockstep_step(cfg):
    """The flat ``make_step`` under ``torch.func.vmap``, as
    ``simulate_batch`` runs it."""
    from repro_torch.core.draws import BatchDraws
    from repro_torch.core.engine import make_step

    flat = make_step(cfg)
    return lambda s, d: torch.func.vmap(flat, in_dims=(0, BatchDraws.in_dims(d)))(s, d)


def eager_run(step, s, draws, ticks, t0=0):
    """``step`` driven by hand, one ``draws.tick(t)`` a tick for t = t0 to
    t0 + ticks - 1: the yardstick of the compiled run. Returns (final
    state, (T, ...) series)."""
    rows = []
    for t in range(t0, t0 + ticks):
        s, y = step(s, draws.tick(t))
        rows.append(y)
    return s, torch.stack(rows)


def leaves_named(s, prefix=""):
    """A state's tensors by field path (nested NamedTuples flattened)."""
    for name in s._fields:
        x = getattr(s, name)
        if hasattr(x, "_fields"):
            yield from leaves_named(x, f"{prefix}{name}.")
        else:
            yield prefix + name, x


def state_differences(a, b):
    """The fields of two states that differ, bit for bit."""
    return [name for (name, x), (_, y) in zip(leaves_named(a), leaves_named(b))
            if x.dtype != y.dtype or x.shape != y.shape
            or x.cpu().numpy().tobytes() != y.cpu().numpy().tobytes()]


def phase12a(dev):
    """Captured == eager on the card, each run's launches and syncs
    checked; returns the census of each run's graph (``graph_census``), by
    tag."""
    from repro_torch.core import BaselineConfig
    from repro_torch.core.baselines import common as C
    from repro_torch.core.baselines import flux_like, ray_like, slurm_like
    from repro_torch.core.baselines.draws import TorchBaselineDraws
    from repro_torch.core.draws import BatchDraws, TorchDraws
    from repro_torch.core.engine import LaminarEngine, make_step, seed_state, summarize
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census
    from repro_torch.kernels import LOCKSTEP
    from repro_torch.profile_tick import exp5_config
    from repro_torch.workloads import SCENARIOS

    graphs = {}
    cases = [(f"Exp5, {'airlock' if a else 'kernel-oom'}",
              exp5_config(a, full=True, ticks=FLAT_TICKS), FLAT_TICKS, None) for a in (False, True)]
    cases += [(f"{name}, airlock", dataclasses.replace(
        exp5_config(True, full=True, ticks=FLAT_PRESET_TICKS), scenario=SCENARIOS[name]),
        FLAT_PRESET_TICKS, None) for name in ("storm", "diurnal")]
    cases.append(("Exp5, airlock, CPU generator", exp5_config(True, full=True,
                                                              ticks=HOST_FED_TICKS),
                  HOST_FED_TICKS, "cpu"))
    for tag, cfg, T, gdev in cases:
        eng = LaminarEngine(cfg, device=dev)
        s, lam = eng.init(0)
        Z = s.zstart.shape[0]
        draws = TorchDraws(cfg, lam, Z, seed=0, device=dev, generator_device=gdev)
        with watching() as runs:
            (final, ts), launches, syncs, wall, _ = counted(lambda: eng.simulate(s, draws, T))
        t0 = time.perf_counter()
        efinal, ets = eager_run(make_step(cfg), s, TorchDraws(cfg, lam, Z, seed=0, device=dev,
                                                              generator_device=gdev), T)
        torch.cuda.synchronize()
        ewall = time.perf_counter() - t0
        got = summarize(cfg, final, ts.cpu().numpy())
        want = summarize(cfg, efinal, ets.cpu().numpy())
        diff = int_differences(want, got) + state_differences(efinal, final)
        check(not diff, f"[12 (a), {tag}] captured and eager differ in {diff}")
        check(torch.equal(ts, ets), f"[12 (a), {tag}] series differ")
        check(launches == want_launches(cfg, T, sharded=False),
              f"[12 (a), {tag}] launches {launches}")
        if gdev is None:
            check(syncs == 0, f"[12 (a), {tag}] {syncs} host syncs in the captured run")
        check_run(tag, got, launches, want_launches(cfg, T, sharded=False), 0)
        graphs[tag] = graph_census(runs[0][0].graph)
        print(f"phase 12 (a) [{tag}]: {T} ticks, started={got['started']} "
              f"suspended={got['suspended_cnt']} node_failures={got['node_failures']}: captured "
              f"== eager bit for bit (every integer metric, lat_hist, the series, every leaf of "
              f"the final state); launches {dict((k, v) for k, v in launches.items() if v)}, "
              f"{syncs} host syncs in the captured run; from init {T / wall:.1f} ticks/s "
              f"captured (capture included), {T / ewall:.1f} eager")

    graphs.update(phase12a_sharded(dev))

    # lockstep seeds 0-3, Airlock on and off (the kill branch under vmap)
    B, T = len(BATCH_SEEDS), BATCH_TICKS
    for airlock in (True, False):
        arm = "airlock" if airlock else "kernel-oom"
        cfg = exp5_config(airlock, full=True, ticks=T)
        eng = LaminarEngine(cfg, device=dev)
        sb, lam = eng.init_batch(BATCH_SEEDS)

        def batch_draws():
            return BatchDraws([TorchDraws(cfg, lam, sb.zstart.shape[1], seed=sd, device=dev)
                               for sd in BATCH_SEEDS])

        draws = batch_draws()
        with watching() as runs:
            (final, ts), launches, syncs, _, _ = counted(
                lambda: eng.simulate_batch(sb, draws, T))
        efinal, ets = eager_run(lockstep_step(cfg), sb, batch_draws(), T)
        ets = ets.movedim(0, 1)
        check(torch.equal(ts, ets), f"[12 (a), lockstep Exp5, {arm}] series differ")
        outs = []
        for i, sd in enumerate(BATCH_SEEDS):
            got = eng._summary(seed_state(final, i), ts[i].cpu().numpy(), lam, sd)
            want = eng._summary(seed_state(efinal, i), ets[i].cpu().numpy(), lam, sd)
            diff = int_differences(want, got) + state_differences(seed_state(efinal, i),
                                                                  seed_state(final, i))
            check(not diff, f"[12 (a), lockstep Exp5, {arm}, seed {sd}] captured and eager "
                  f"differ in {diff}")
            outs.append(got)
        want = dict.fromkeys(launches, 0)
        want.update(dict.fromkeys(LOCKSTEP, T))
        check(launches == want and syncs == 0, f"[12 (a), lockstep Exp5, {arm}] launches "
              f"{launches}, {syncs} syncs")
        kills = [o["oom_kill_l"] + o["oom_kill_f"] for o in outs]
        suspended = [o["suspended_cnt"] for o in outs]
        if not airlock:
            check(min(kills) > 0 and max(suspended) == 0,
                  f"[12 (a), lockstep Exp5, {arm}] kills {kills}, suspended {suspended}")
        graphs[f"lockstep Exp5, {arm}, B = {B}"] = graph_census(runs[0][0].graph)
        print(f"phase 12 (a) [lockstep Exp5, {arm}, seeds {BATCH_SEEDS}]: {T} ticks, kills "
              f"{kills} suspended {suspended}: captured == eager bit for bit, seed by seed; "
              f"launches {dict((k, v) for k, v in launches.items() if v)}, {syncs} host syncs")

    # the baselines at Exp1's geometry
    bcfg, ecfg = BaselineConfig(), exp1_config()
    for name, mod in (("slurm", slurm_like), ("ray", ray_like), ("flux", flux_like)):
        s, lam = mod.init(ecfg, 0, EXP1_CAPACITY, dev)
        step = mod.make_step(ecfg, bcfg)

        def bdraws():
            return TorchBaselineDraws(name, ecfg, lam, EXP1_CAPACITY, 0, dev)

        draws = bdraws()
        with watching() as runs:
            (final, ys), launches, syncs, wall, _ = counted(
                lambda: C.simulate(step, s, draws, CAPTURED_BASELINE_TICKS))
        t0 = time.perf_counter()
        efinal, eys = eager_run(step, s, bdraws(), CAPTURED_BASELINE_TICKS)
        torch.cuda.synchronize()
        ewall = time.perf_counter() - t0
        diff = state_differences(efinal, final)
        check(not diff and torch.equal(ys, eys),
              f"[12 (a), {name}] captured and eager differ in {diff or 'the series'}")
        check(sum(launches.values()) == 0 and syncs == 0,
              f"[12 (a), {name}] launches {launches}, {syncs} syncs")
        graphs[name] = graph_census(runs[0][0].graph)
        out = C.summarize_baseline(ecfg, final.metrics, final.tt)
        print(f"phase 12 (a) [{name}, Exp1]: {CAPTURED_BASELINE_TICKS} ticks, "
              f"started={out['started']}: "
              f"captured == eager bit for bit (the series and every leaf of the final state); "
              f"{syncs} host syncs; from init {CAPTURED_BASELINE_TICKS / wall:.1f} ticks/s "
              f"captured (capture included), {CAPTURED_BASELINE_TICKS / ewall:.1f} eager")
    return graphs


def replay_syncs(compiled, n=20):
    """Host syncs in ``n`` replays of a compiled run's graph
    (``set_sync_debug_mode``)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                compiled.graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


def phase12a_sharded(dev):
    """The zone-sharded engine's captured run against ``make_step`` with its
    mesh plane driven by hand, on the one-rank NCCL group: Exp5 Airlock off
    and on (TICKS), storm (PRESET_TICKS), and GEOMETRY_SEEDS through one
    engine; each run's launches from its graph, 0 host syncs in its replays.
    Returns the census of each run's graph, by tag."""
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.engine import make_step, summarize
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine
    from repro_torch.profile_tick import exp5_config
    from repro_torch.workloads import SCENARIOS

    graphs = {}
    cases = [(f"sharded Exp5, {'airlock' if a else 'kernel-oom'}",
              exp5_config(a, full=True, ticks=TICKS), TICKS, (0,)) for a in (False, True)]
    cases.append(("sharded storm, airlock", dataclasses.replace(
        exp5_config(True, full=True, ticks=PRESET_TICKS), scenario=SCENARIOS["storm"]),
        PRESET_TICKS, (0,)))
    cases.append(("sharded Exp5, airlock, two geometries",
                  exp5_config(True, full=True, ticks=GEOMETRY_TICKS), GEOMETRY_TICKS,
                  GEOMETRY_SEEDS))
    for tag, cfg, T, seeds in cases:
        eng = ZoneShardedEngine(cfg, num_devices=1, device=dev)
        zones = []
        for sd in seeds:
            s, lam = eng.init(sd)
            Z = s.zstart.shape[0]
            zones.append((tuple(s.zmember.shape), s.zcount.cpu().tolist()))
            draws = TorchDraws(cfg, lam, Z, seed=sd, device=dev)
            with watching() as runs:
                (final, ts), launches, syncs, wall, gathers = counted(
                    lambda: eng.simulate(s, draws, T))
            t0 = time.perf_counter()
            efinal, ets = eager_run(make_step(cfg, plane=eng._plane(s)), s,
                                    TorchDraws(cfg, lam, Z, seed=sd, device=dev), T)
            torch.cuda.synchronize()
            ewall = time.perf_counter() - t0
            got = summarize(cfg, final, ts.cpu().numpy())
            want = summarize(cfg, efinal, ets.cpu().numpy())
            diff = int_differences(want, got) + state_differences(efinal, final)
            label = f"{tag}, seed {sd}"
            check(not diff, f"[12 (a), {label}] captured and eager differ in {diff}")
            check(torch.equal(ts, ets), f"[12 (a), {label}] series differ")
            # each run captures: a new engine, or a seed of another geometry
            check_run(label, got, launches, want_launches(cfg, T, sharded=True), syncs, gathers,
                      CAPTURE_GATHERS, SHARDED_RUN_SYNCS)
            in_replays = replay_syncs(runs[0][0])
            check(in_replays == 0, f"[12 (a), {label}] {in_replays} host syncs in 20 replays")
            graphs[label] = graph_census(runs[0][0].graph)
            print(f"phase 12 (a) [{label}]: {T} ticks, started={got['started']} "
                  f"suspended={got['suspended_cnt']} node_failures={got['node_failures']}: "
                  f"captured == eager bit for bit (every integer metric, lat_hist, the series, "
                  f"every leaf of the final state); launches "
                  f"{dict((k, v) for k, v in launches.items() if v)} (graph nodes x replays), "
                  f"{syncs} host sync in the run (the zone digest, before its first tick), "
                  f"{in_replays} in 20 replays; {gathers} all_gather_into_tensor calls (warm-up "
                  f"and capture); from init {T / wall:.1f} ticks/s captured (capture included), "
                  f"{T / ewall:.1f} eager")
        if len(seeds) > 1:
            check(len({z[0] for z in zones}) == 1
                  and len({str(z[1]) for z in zones}) == len(seeds),
                  f"[12 (a), {tag}] the seeds' zones {zones}: want equal shapes, other zones")
            check(len(eng._compiled) == len(seeds),
                  f"[12 (a), {tag}] {len(eng._compiled)} compiled ticks for {len(seeds)} "
                  f"geometries")
            print(f"phase 12 (a) [{tag}]: seeds {seeds}, zones of (Z, M) = {zones[0][0]}, sizes "
                  f"differ: one compiled tick each ({len(eng._compiled)})")
    return graphs


def phase12b(graphs):
    """Each captured tick's graph: its hand-written kernel nodes (a lockstep
    tick's: each entry once for all seeds), host memcpy nodes."""
    from repro_torch.kernel_bench import tick_entries

    for tag, c in graphs.items():
        entries = tick_entries(c["names"])
        if tag in ("slurm", "ray", "flux"):
            want = {}
        else:
            sharded = tag.startswith("sharded")
            rounds = "bitmap_fit_rounds_blocked" if sharded else "bitmap_fit_rounds"
            want = {rounds: 1, "utility_topk_address": 1, "zone_aggregate_members": 1,
                    "survival_scan": 1, "node_view": 1}
        check(entries == want, f"[12 (b), {tag}] hand-written kernel nodes {entries} != {want}")
        check(c["host_memcpy"] == 0, f"[12 (b), {tag}] {c['host_memcpy']} memcpy nodes touch "
              f"host memory")
        print(f"phase 12 (b) [{tag}]: a tick's graph holds {c['kernel']} kernel nodes "
              f"(hand-written: {entries or 'none'}; NCCL: {c['nccl']}), {c['memcpy']} memcpy "
              f"({c['host_memcpy']} touching host memory), {c['memset']} memset, "
              f"{c['other']} other")


def timed(fn):
    """Seconds of ``fn()`` on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def eager_rate(step, s, draws):
    """Ticks/s of ticks RATE_WARMUP on, ``step`` driven by hand."""
    s1, _ = eager_run(step, s, draws, RATE_WARMUP)
    return RATE_TICKS / timed(lambda: eager_run(step, s1, draws, RATE_TICKS, RATE_WARMUP))


def captured_rate(run, s, draws):
    """The same through ``run`` (``simulate``), its capture made first."""
    s1, _ = run(s, draws, RATE_WARMUP)
    return RATE_TICKS / timed(lambda: run(s1, draws, RATE_TICKS))


def phase12c(dev, eager_lockstep):
    """Captured against eager rates, each on its own host clock."""
    from repro_torch.core import BaselineConfig
    from repro_torch.core.baselines import common as C
    from repro_torch.core.baselines import flux_like, ray_like, slurm_like
    from repro_torch.core.baselines.draws import TorchBaselineDraws
    from repro_torch.core.engine import LaminarEngine, make_step
    from repro_torch.profile_tick import exp5_config, exp7_config

    for airlock in (False, True):
        cfg = exp5_config(airlock, full=True)
        eng = LaminarEngine(cfg, device=dev)
        s, lam = eng.init(0)
        Z = s.zstart.shape[0]
        rates = []
        for kind in ("eager", "captured", "captured", "eager"):
            d = eng.draws(lam, Z, 0)
            rates.append(eager_rate(make_step(cfg), s, d) if kind == "eager"
                         else captured_rate(eng.simulate, s, d))
        print(f"phase 12 (c) [Exp5, {'airlock' if airlock else 'kernel-oom'}]: ticks "
              f"{RATE_WARMUP} to {RATE_WARMUP + RATE_TICKS - 1}, ticks/s eager, captured, "
              f"captured, eager: {', '.join(f'{r:.1f}' for r in rates)}")
    cfg = exp7_config()
    eng = LaminarEngine(cfg, device=dev)
    s, lam = eng.init(0)
    Z = s.zstart.shape[0]
    eng.simulate(s, eng.draws(lam, Z, 1), 2)  # the capture, apart from the timed run
    step, d = make_step(cfg), eng.draws(lam, Z, 0)
    e7 = EXP7_TICKS / timed(lambda: eager_run(step, s, d, EXP7_TICKS))
    c7 = EXP7_TICKS / timed(lambda: eng.simulate(s, eng.draws(lam, Z, 0), EXP7_TICKS))
    print(f"phase 12 (c) [Exp7 top cell, flat]: {EXP7_TICKS} ticks from init, ticks/s eager "
          f"{e7:.1f}, captured {c7:.1f} (capture made before)")
    cfg = exp5_config(True, full=True)
    eng = LaminarEngine(cfg, device=dev)
    captured = {}
    for B in BATCH_SIZES:
        sb, draws, _ = lockstep(eng, list(range(B)))
        s1, _ = eng.simulate_batch(sb, draws, BATCH_WARMUP)
        captured[B] = B * BATCH_TIMED / timed(lambda: eng.simulate_batch(s1, draws, BATCH_TIMED))
    print(f"phase 12 (c) [lockstep, Exp5, Airlock on]: seed-ticks/s, ticks {BATCH_WARMUP} to "
          f"{BATCH_WARMUP + BATCH_TIMED - 1}: "
          + ", ".join(f"B = {B} eager {eager_lockstep[B]:.1f} (11 (d)) captured "
                      f"{captured[B]:.1f}" for B in BATCH_SIZES))
    bcfg, ecfg = BaselineConfig(), exp1_config()
    for name, mod in (("slurm", slurm_like), ("ray", ray_like), ("flux", flux_like)):
        s, lam = mod.init(ecfg, 0, EXP1_CAPACITY, dev)
        step = mod.make_step(ecfg, bcfg)
        e = eager_rate(step, s, TorchBaselineDraws(name, ecfg, lam, EXP1_CAPACITY, 0, dev))
        c = captured_rate(lambda *a: C.simulate(step, *a), s,
                          TorchBaselineDraws(name, ecfg, lam, EXP1_CAPACITY, 0, dev))
        print(f"phase 12 (c) [{name}, Exp1]: ticks/s eager {e:.1f}, captured {c:.1f} (a "
              f"capture each call, as the reference jits each run; included)")


def phase12d(dev):
    """The replayed tick's profile: flat and sharded Exp5 both ways,
    lockstep B = 8."""
    from repro_torch.core.engine import LaminarEngine
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine
    from repro_torch.profile_tick import exp5_config, print_replayed, replayed_window

    for airlock in (False, True):
        cfg = exp5_config(airlock, full=True)
        eng = LaminarEngine(cfg, device=dev)
        s, lam = eng.init(0)
        print(f"phase 12 (d) [Exp5, {'airlock' if airlock else 'kernel-oom'}]:")
        print_replayed(replayed_window(eng, s, eng.draws(lam, s.zstart.shape[0], 0),
                                       lockstep=False))
        sharded = ZoneShardedEngine(cfg, num_devices=1, device=dev)
        print(f"phase 12 (d) [sharded Exp5, {'airlock' if airlock else 'kernel-oom'}]:")
        print_replayed(replayed_window(sharded, s, sharded.draws(lam, s.zstart.shape[0], 0),
                                       lockstep=False))
    B = max(BATCH_SIZES)
    eng = LaminarEngine(exp5_config(True, full=True), device=dev)
    sb, draws, _ = lockstep(eng, list(range(B)))
    print(f"phase 12 (d) [lockstep, B = {B}]:")
    print_replayed(replayed_window(eng, sb, draws, lockstep=True))


def phase12(dev, eager_lockstep):
    graphs = phase12a(dev)
    phase12b(graphs)
    phase12c(dev, eager_lockstep)
    phase12d(dev)


# ---------------------------------------------------------------------------
# phase 13: the examples and dev smokes, through each one's main(argv)
# ---------------------------------------------------------------------------

SCRIPTS = {
    "quickstart": "examples/torch_quickstart.py",
    "cluster_survival": "examples/torch_cluster_survival.py",
    "serve_laminar": "examples/torch_serve_laminar.py",
    "train_lm": "examples/torch_train_lm.py",
    "smoke_engine": "scripts/torch_smoke_engine.py",
    "smoke_baselines": "scripts/torch_smoke_baselines.py",
    "smoke_models": "scripts/torch_smoke_models.py",
}
TRAIN_EXAMPLE_STEPS = 20  # cut from the example's 200 for the script's time limit
NON_FINITE = re.compile(r"(?<![\w.])[-+]?(nan|inf)(?![\w.])", re.IGNORECASE)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
            else f"nvidia-smi unavailable (rc {smi.returncode})")


def load_script(name: str):
    """The port's script ``name`` as a module (it runs nothing on import)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_{name}", ROOT / SCRIPTS[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script_run(name: str, argv, card: str):
    """``main(argv)`` of the port's script ``name``: every launch counter set
    to 0 just before, read just after. Returns (the module, its result, its
    printed text, the hand-written launches of each compiled run: its
    graph's kernel nodes by entry times its replays, its seconds of wall
    time). The text is echoed, and checked to hold no NaN or infinity."""
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census, tick_entries

    mod = load_script(name)
    torch.cuda.synchronize()
    counters = wrappers()
    for w in counters.values():
        w.launches = 0
    text = io.StringIO()
    with watching() as runs, contextlib.redirect_stdout(text):
        t0 = time.perf_counter()
        result = mod.main(list(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    text = text.getvalue()
    for line in text.splitlines():
        print(f"  | {line}")
    per_run = [{e: n * replays for e, n in tick_entries(graph_census(c.graph)["names"]).items()}
               for c, replays in runs]
    eager = {k: w.launches for k, w in counters.items() if w.launches}
    print(f"phase 13 [{name}]: {wall:.2f} s wall, {len(runs)} compiled runs, eager launches "
          f"(warm-ups and captures) {eager} ({card})")
    check(not NON_FINITE.search(text), f"[{name}] printed a NaN or an infinity")
    return mod, result, text, per_run, wall


def check_tick_launches(name, per_run, ticks, memory):
    """Each compiled run launched the flat tick's kernels once a tick:
    survival_scan only with memory on, the other four always."""
    from repro_torch.kernels import LOCKSTEP

    for i, launches in enumerate(per_run):
        for entry in LOCKSTEP:
            want = ticks if memory or entry != "survival_scan" else 0
            check(launches.get(entry, 0) == want,
                  f"[{name}] run {i}: {entry} launched {launches.get(entry, 0)} times, "
                  f"want {want}")


def phase13(dev):
    from repro_torch.configs import list_archs

    card = card_line()
    mod, out, text, per_run, wall = script_run("quickstart", [], card)
    ticks = mod.CFG.num_ticks
    check(text == mod.report(mod.CFG, out) + "\n", "[quickstart] printed text")
    check(conservation(out) and out["started"] > 0, "[quickstart] task conservation broken")
    check(len(per_run) == 1, f"[quickstart] {len(per_run)} compiled runs")
    check_tick_launches("quickstart", per_run, ticks, memory=False)
    print(f"phase 13 [quickstart]: {ticks} ticks, {wall / ticks * 1e3:.3f} ms a tick from "
          f"init (capture included), started={out['started']}, launches {per_run[0]} ({card})")

    mod, outs, text, per_run, wall = script_run("cluster_survival", [], card)
    ticks = mod.BASE.num_ticks
    cfgs = [dataclasses.replace(mod.BASE, airlock=a) for a in (False, True)]
    check(text == "".join(mod.report(c, o) + "\n" for c, o in zip(cfgs, outs)),
          "[cluster_survival] printed text")
    for cfg, o in zip(cfgs, outs):
        check(conservation(o) and o["started"] > 0,
              f"[cluster_survival] airlock={cfg.airlock}: task conservation broken")
    check(outs[1]["oom_kill_l"] == 0,
          f"[cluster_survival] {outs[1]['oom_kill_l']} L-task OOM kills with Airlock on")
    check(len(per_run) == 2, f"[cluster_survival] {len(per_run)} compiled runs")
    check_tick_launches("cluster_survival", per_run, ticks, memory=True)
    print(f"phase 13 [cluster_survival]: {ticks} ticks a run, {wall / (2 * ticks) * 1e3:.3f} ms "
          f"a tick from init (captures included), L-task OOM kills {outs[0]['oom_kill_l']} -> "
          f"{outs[1]['oom_kill_l']}, launches {per_run} ({card})")

    _, _, text, per_run, _ = script_run("serve_laminar", [], card)
    stats = re.match(r"arch=\S+ replicas=2 arrived=(\d+) started=(\d+) completed=(\d+) "
                     r"suspended=\d+ resumed=\d+ migrated=\d+ reclaimed=\d+ fastfail=\d+$",
                     text.splitlines()[0] if text else "")
    check(stats is not None and int(stats.group(2)) > 0, "[serve_laminar] stats line")
    check(all(not any(r.values()) for r in per_run), "[serve_laminar] a hand-written launch")

    with tempfile.TemporaryDirectory() as tmp:
        _, out, text, _, _ = script_run(
            "train_lm", ["--steps", str(TRAIN_EXAMPLE_STEPS), "--ckpt-dir", tmp], card)
    losses = np.asarray(out["losses"])
    check(len(losses) == TRAIN_EXAMPLE_STEPS and np.isfinite(losses).all(),
          f"[train_lm] losses {losses}")
    check(f"final loss after {TRAIN_EXAMPLE_STEPS} steps: {out['final_loss']:.4f}" in text
          and len(out["log"]) == TRAIN_EXAMPLE_STEPS, "[train_lm] printed lines")
    print(f"phase 13 [train_lm]: {TRAIN_EXAMPLE_STEPS} steps (cut from the example's 200), "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({card})")

    mod, got, text, per_run, _ = script_run("smoke_engine", [], card)
    check(text == mod.report(got["runs"][0], *got["seconds"]) + "\n", "[smoke_engine] text")
    for o in got["runs"]:
        check(conservation(o) and o["started"] > 0, "[smoke_engine] task conservation broken")
    check(len(per_run) == 2, f"[smoke_engine] {len(per_run)} compiled runs")
    check_tick_launches("smoke_engine", per_run, mod.CFG.num_ticks, memory=False)
    print(f"phase 13 [smoke_engine]: first run (capture) {got['seconds'][0]:.3f} s, second "
          f"(replay) {got['seconds'][1]:.3f} s, {mod.CFG.num_ticks} ticks each ({card})")

    mod, got, text, per_run, _ = script_run("smoke_baselines", [], card)
    check(list(got) == ["slurm", "ray", "flux"] and len(text.splitlines()) == 3,
          "[smoke_baselines] runs")
    for name, o in got.items():
        check(o["started"] > 0 and np.isfinite(o["start_success_raw"]),
              f"[smoke_baselines] {name}: started={o['started']}")
    check(all(not any(r.values()) for r in per_run), "[smoke_baselines] a hand-written launch")

    _, got, _, _, _ = script_run("smoke_models", [], card)
    check(list(got) == list_archs(), f"[smoke_models] archs {list(got)}")
    for name, r in got.items():
        check(r["shapes_ok"] and r["finite"], f"[smoke_models] {name}: {r}")
    print(f"phase 13 [smoke_models]: {len(got)} archs, forward, loss, prefill and decode "
          f"finite with the right shapes, {sum(r['wall'] for r in got.values()):.2f} s ({card})")


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
    from repro_torch.kernels import _build
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
            totals = dict.fromkeys(wrappers(), 0)
            gloo = dist.new_group(ranks=[0], backend="gloo")
            done = {}
            for k, run in ((3, lambda: phase3(dev, totals)), (4, lambda: phase4(dev, gloo)),
                           (5, lambda: phase5(dev, totals)), (6, lambda: phase6(dev, totals)),
                           (7, lambda: phase7(dev)), (8, lambda: phase8(dev)),
                           (9, lambda: phase9(dev)), (10, lambda: phase10(dev, done[9])),
                           (11, lambda: phase11(dev, totals, rows)),
                           (12, lambda: phase12(dev, done[11])), (13, lambda: phase13(dev))):
                t1 = time.perf_counter()
                done[k] = run()
                print(f"phase {k}: {time.perf_counter() - t1:.1f} s wall")
            for name, row in rows.items():  # the fixture rows: 0, on no main path
                row["launches"] = totals.get(name, 0)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        finally:
            dist.destroy_process_group()

    print(f"total wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
