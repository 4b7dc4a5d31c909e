"""Launch plan of ``csrc/survival_scan.cu``: up to nine dependent launches.

Slot order (the launcher's): init, count, scan, place, fold over nodes and
slots, then tier (Airlock only), score, slot and mask over the probe table.
The slot-wide launches are left out for an empty table, as the node
accumulators still need their fold. The int32 scratch is carved into eight
slices (``Carve``) whose offsets the launcher takes from here; it refuses a
layout that leaves the scratch the wrapper allocated.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.launch_plan import Carve, Launch, LaunchPlan, Operand, Output, cdiv

# the launcher's slot order, and the order of survival_scan_attrs
KERNELS = (
    "init_kernel", "count_kernel", "scan_kernel", "place_kernel", "fold_kernel",
    "tier_kernel", "score_kernel", "slot_kernel", "mask_kernel",
)
THREADS = 256  # kThreads of csrc/survival_scan.cu
SCAN_THREADS = 1024  # kScanThreads
SCAN_STATIC_SMEM = SCAN_THREADS * 4  # part[kScanThreads] int32
COLUMNS = ("st", "alloc_node", "mem", "ev", "tier", "migrating", "susp_tick", "surv_deadline")


def scratch_words(P: int, N: int) -> int:
    """Words of int32 scratch: ``survival_scan_scratch_words`` of the source."""
    return 6 * N + 1 + 2 * P


def scratch_layout(P: int, N: int) -> Tuple[Carve, ...]:
    sizes = (("cnt", N), ("cur", N), ("off", N + 1), ("btier", N), ("bscore", N),
             ("bslot", N), ("eslot", P), ("eval", P))
    out, at = [], 0
    for name, words in sizes:
        out.append(Carve(name, at, words))
        at += words
    return tuple(out)


@functools.lru_cache(maxsize=None)
def plan(P: int, N: int, airlock: bool) -> LaunchPlan:
    nb, pb = cdiv(N, THREADS), cdiv(P, THREADS)
    cols = tuple(Operand(c, P, THREADS) for c in COLUMNS)
    node_acc = tuple(Operand(c, N, THREADS, write=True)
                     for c in ("cnt", "cur", "btier", "bscore", "bslot"))
    masks = tuple(Operand(m, P, THREADS, write=True)
                  for m in ("victim", "resume", "react", "expire"))
    launches = [
        Launch("init_kernel", nb, THREADS, node_acc),
        Launch("count_kernel", pb, THREADS, cols),
        Launch("scan_kernel", 1, SCAN_THREADS,
               (Operand("cnt", N, N), Operand("off", N + 1, N + 1, write=True)),
               static_smem=SCAN_STATIC_SMEM),
        Launch("place_kernel", pb, THREADS, cols),
        Launch("fold_kernel", nb, THREADS,
               (Operand("base", N, THREADS), Operand("pressure", N, THREADS, write=True))),
        Launch("tier_kernel", pb, THREADS, cols),
        Launch("score_kernel", pb, THREADS, cols),
        Launch("slot_kernel", pb, THREADS, cols),
        Launch("mask_kernel", pb, THREADS, cols + masks),
    ]
    launches = [L for L in launches if L.grid > 0 and (airlock or L.kernel != "tier_kernel")]
    return LaunchPlan(
        entry="survival_scan",
        source="survival_scan",
        launches=tuple(launches),
        outputs=(Output("pressure", (N,), torch.float32),
                 *(Output(m, (P,), torch.bool) for m in ("victim", "resume", "react", "expire"))),
        scratch_words=scratch_words(P, N),
        scratch=scratch_layout(P, N),
    )


def pack(p: LaunchPlan):
    """``p`` as the launcher takes it: grids and blocks per slot (grid 0: not
    launched) and the scratch offsets, as ctypes int arrays."""
    by_name = {L.kernel: L for L in p.launches}
    arr = ctypes.c_int * len(KERNELS)
    grids = arr(*(by_name[k].grid if k in by_name else 0 for k in KERNELS))
    blocks = arr(*(by_name[k].block if k in by_name else 0 for k in KERNELS))
    return grids, blocks, (ctypes.c_int * len(p.scratch))(*(c.offset for c in p.scratch))


@functools.lru_cache(maxsize=None)
def slot_args(P: int, N: int, airlock: bool):
    """:func:`pack` of :func:`plan`, cached by shape (a plan hashes slowly)."""
    return pack(plan(P, N, airlock))


def for_call(st, alloc_node, mem, ev, tier, migrating, susp_tick, surv_deadline, base, t,
             *, airlock: bool, **_) -> LaunchPlan:
    return plan(st.shape[0], base.shape[0], bool(airlock))
