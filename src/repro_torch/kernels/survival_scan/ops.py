"""survival_scan wrapper: the CUDA kernel for a CUDA tensor, else the plain version."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launch_plan import LaunchPlan
from repro_torch.kernels.survival_scan import plan as _plan
from repro_torch.kernels.survival_scan.ref import survival_scan_ref

__all__ = ["survival_scan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIG = {
    "survival_scan_launch": [_P] * 16 + [_I, _I, _I, _F, _F, _F] + [_I] * 9 + [_P],
}


def launch(
    plan: LaunchPlan, outs, st, alloc_node, mem, ev, tier, migrating, susp_tick,
    surv_deadline, base, t, *, airlock: bool, residual: float, watermark: float,
    safe: float, t_susp: int, t_surv: int, scratch=None,
) -> None:
    """Launch ``plan`` (one cluster) into ``outs`` (pressure, victim,
    resume, react, expire), allocated by the caller; ``scratch`` (the plan's
    ``scratch_words`` int32: the fold's entries and a word a node) is
    allocated here unless given. Counts nothing."""
    P, N = st.shape[0], base.shape[0]
    for x, dtype, what in (
        (st, torch.int32, "st"),
        (alloc_node, torch.int32, "alloc_node"),
        (mem, torch.float32, "mem"),
        (ev, torch.float32, "ev"),
        (tier, torch.int32, "tier"),
        (migrating, torch.bool, "migrating"),
        (susp_tick, torch.int32, "susp_tick"),
        (surv_deadline, torch.int32, "surv_deadline"),
    ):
        _build.expect(x, dtype, (P,), f"survival_scan {what}")
    _build.expect(base, torch.float32, (N,), "survival_scan base")
    _build.expect(t, torch.int32, (), "survival_scan t")
    for x, o in zip(outs, plan.outputs):
        _build.expect(x, o.dtype, o.shape, f"survival_scan {o.name}")
    if scratch is None:
        scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=st.device)
    _build.expect(scratch, torch.int32, (plan.scratch_words,), "survival_scan scratch")
    if plan is _plan.plan(P, N, bool(airlock)):
        geometry = _plan.launch_args(P, N, bool(airlock))
    else:  # a plan built elsewhere: launch exactly that one
        geometry = _plan.pack(plan)
    lib = _build.load("survival_scan", _SIG)
    ptr = _build.ptr
    err = lib.survival_scan_launch(
        *(ptr(x) for x in (st, alloc_node, mem, ev, tier, migrating, susp_tick,
                           surv_deadline, base, t, *outs, scratch)),
        P, N, int(airlock), float(residual), float(watermark), float(safe),
        int(t_susp), int(t_surv), *geometry, plan.scratch_words, _build.stream(st),
    )
    _build.check(err, "survival_scan")


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
    st,
    alloc_node,
    mem,
    ev,
    tier,
    migrating,
    susp_tick,
    surv_deadline,
    base,
    t,
    *,
    airlock: bool,
    residual: float,
    watermark: float,
    safe: float,
    t_susp: int,
    t_surv: int,
):
    """Per-tick survival decision: (pressure, victim, resume, react, expire).

    Columns (P,): ``st``, ``alloc_node``, ``tier``, ``susp_tick``,
    ``surv_deadline`` int32; ``mem``, ``ev`` float32; ``migrating`` bool.
    ``base`` (N,) float32; ``t`` a 0-d int32 tensor on the same device (the
    kernel reads it there, so no host sync). CPU tensors take
    :func:`survival_scan_ref`.
    """
    kw = dict(
        airlock=airlock, residual=residual, watermark=watermark, safe=safe,
        t_susp=t_susp, t_surv=t_surv,
    )
    args = (st, alloc_node, mem, ev, tier, migrating, susp_tick, surv_deadline, base, t)
    if not st.is_cuda:
        return survival_scan_ref(*args, **kw)
    plan = _plan.for_call(*args, **kw)
    outs = plan.new_outputs(st.device)
    launch(plan, outs, *args, **kw)
    survival_scan.launches += 1
    return tuple(outs)


survival_scan.launches = 0
