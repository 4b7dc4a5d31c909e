"""survival_scan wrappers: the CUDA kernel for a CUDA tensor, else the plain version.

``survival_scan`` runs one seed's table (one cluster) or, given a leading
seed axis, B seeds' tables in one launch (B clusters), and counts its
launches. ``survival_scan_op`` is the custom op the tick calls
(``core.hotpath``): the wrapper, called once with the seed axis as its
batching rule under ``torch.func.vmap`` (``kernels.batching``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.kernels import _build
from repro_torch.kernels.batching import dispatch, register_batching
from repro_torch.kernels.launch_plan import LaunchPlan
from repro_torch.kernels.survival_scan import plan as _plan
from repro_torch.kernels.survival_scan.ref import survival_scan_ref

__all__ = ["survival_scan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIG = {
    "survival_scan_launch": [_P] * 16 + [_I, _I, _I, _F, _F, _F] + [_I] * 9 + [_P],
    "survival_scan_batched_launch": [_P] * 16 + [_I, _I, _I, _F, _F, _F] + [_I] * 10 + [_P],
}
_COLUMNS = (("st", torch.int32), ("alloc_node", torch.int32), ("mem", torch.float32),
            ("ev", torch.float32), ("tier", torch.int32), ("migrating", torch.bool),
            ("susp_tick", torch.int32), ("surv_deadline", torch.int32))


def launch(
    plan: LaunchPlan, outs, st, alloc_node, mem, ev, tier, migrating, susp_tick,
    surv_deadline, base, t, *, airlock: bool, residual: float, watermark: float,
    safe: float, t_susp: int, t_surv: int, scratch=None, lib=None,
) -> None:
    """Launch ``plan`` into ``outs`` (pressure, victim, resume, react,
    expire), allocated by the caller: one cluster, or for a batched plan B
    clusters, one a seed, with every tensor's leading seed axis (columns (B,
    P), ``base`` (B, N), ``t`` (B,)). ``scratch`` (the plan's
    ``scratch_words`` int32: the fold's entries and a word a node, a stride
    a seed) is allocated here unless given; ``lib`` another build of the
    source (a benchmark's), else the port's. Counts nothing."""
    lead, P, N = plan.lead, st.shape[-1], base.shape[-1]
    cols = (st, alloc_node, mem, ev, tier, migrating, susp_tick, surv_deadline)
    for x, (what, dtype) in zip(cols, _COLUMNS):
        _build.expect(x, dtype, (*lead, P), f"{plan.entry} {what}")
    _build.expect(base, torch.float32, (*lead, N), f"{plan.entry} base")
    _build.expect(t, torch.int32, lead, f"{plan.entry} t")
    for x, o in zip(outs, plan.outputs):
        _build.expect(x, o.dtype, o.shape, f"{plan.entry} {o.name}")
    if scratch is None:
        scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=st.device)
    _build.expect(scratch, torch.int32, (plan.scratch_words,), f"{plan.entry} scratch")
    if plan is _plan.plan(P, N, bool(airlock)):
        geometry = _plan.launch_args(P, N, bool(airlock))
    else:  # a batched plan, or one built elsewhere: launch exactly that one
        geometry = _plan.pack(plan)
    lib = lib or _build.load("survival_scan", _SIG)
    args = (*(_build.ptr(x) for x in (*cols, base, t, *outs, scratch)), P, N, int(airlock),
            float(residual), float(watermark), float(safe), int(t_susp), int(t_surv), *geometry)
    if plan.seeds:
        err = lib.survival_scan_batched_launch(*args, plan.seeds, plan.scratch_words,
                                               _build.stream(st))
    else:
        err = lib.survival_scan_launch(*args, plan.scratch_words, _build.stream(st))
    _build.check(err, plan.entry)


def cluster_occupancy(plan: LaunchPlan) -> dict:
    """How the card takes ``plan``'s cluster launch, with the launcher's
    attributes set: ``clusters`` that can be resident at once
    (``cudaOccupancyMaxActiveClusters``; 0: it cannot launch), the kernel's
    ``max_dynamic_smem`` and ``nonportable`` attribute. Needs the card."""
    (L,) = plan.launches
    fn = "survival_scan_cluster_occupancy"
    lib = _build.load("survival_scan", {fn: [_I, _I, _I, _P]})
    out = (ctypes.c_int * 3)()
    _build.check(getattr(lib, fn)(L.cluster, L.dynamic_smem, int(L.cluster_nonportable), out), fn)
    return {"clusters": out[0], "max_dynamic_smem": out[1], "nonportable": out[2]}


def survival_scan(
    st, alloc_node, mem, ev, tier, migrating, susp_tick, surv_deadline, base, t, *,
    airlock: bool, residual: float, watermark: float, safe: float, t_susp: int, t_surv: int,
):
    """Per-tick survival decision: (pressure, victim, resume, react, expire).

    Columns (P,): ``st``, ``alloc_node``, ``tier``, ``susp_tick``,
    ``surv_deadline`` int32; ``mem``, ``ev`` float32; ``migrating`` bool.
    ``base`` (N,) float32; ``t`` a 0-d int32 tensor on the same device (the
    kernel reads it there, so no host sync). With a leading seed axis on
    every tensor (columns (B, P), ``base`` (B, N), ``t`` (B,)) the outputs
    have it too: one launch of B clusters. CPU tensors take
    :func:`survival_scan_ref`, seed by seed.
    """
    kw = dict(
        airlock=airlock, residual=residual, watermark=watermark, safe=safe,
        t_susp=t_susp, t_surv=t_surv,
    )
    args = (st, alloc_node, mem, ev, tier, migrating, susp_tick, surv_deadline, base, t)
    return dispatch(survival_scan, _plan.for_call(*args, **kw), launch, survival_scan_ref,
                    *args, **kw)


survival_scan.launches = 0


@torch.library.custom_op("repro_torch::survival_scan", mutates_args=(),
                         device_types=("cpu", "cuda"))
def survival_scan_op(
    st: Tensor, alloc_node: Tensor, mem: Tensor, ev: Tensor, tier: Tensor, migrating: Tensor,
    susp_tick: Tensor, surv_deadline: Tensor, base: Tensor, t: Tensor, *, airlock: bool,
    residual: float, watermark: float, safe: float, t_susp: int, t_surv: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """:func:`survival_scan` as a custom op (the wrapper, looked up at each
    call); under ``vmap``, one call of it with the seed axis."""
    return survival_scan(
        st, alloc_node, mem, ev, tier, migrating, susp_tick, surv_deadline, base, t,
        airlock=airlock, residual=residual, watermark=watermark, safe=safe, t_susp=t_susp,
        t_surv=t_surv,
    )


@survival_scan_op.register_fake
def _(st, alloc_node, mem, ev, tier, migrating, susp_tick, surv_deadline, base, t, **_):
    P = st.shape[0]
    return (base.new_empty(base.shape), *(st.new_empty((P,), dtype=torch.bool) for _ in range(4)))


register_batching(survival_scan_op, survival_scan)
