"""survival_scan wrapper: the CUDA kernel for a CUDA tensor, else the plain version."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.survival_scan.ref import survival_scan_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIG = {
    "survival_scan_launch": [_P] * 16 + [_I, _I, _I, _F, _F, _F, _I, _I, _P],
    "survival_scan_scratch_words": [_I, _I],
}


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
    if not st.is_cuda:
        return survival_scan_ref(
            st, alloc_node, mem, ev, tier, migrating, susp_tick, surv_deadline,
            base, t, **kw,
        )
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
    dev = st.device
    lib = _build.load("survival_scan", _SIG)
    pressure = torch.empty(N, dtype=torch.float32, device=dev)
    masks = [torch.empty(P, dtype=torch.bool, device=dev) for _ in range(4)]
    scratch = torch.empty(
        lib.survival_scan_scratch_words(P, N), dtype=torch.int32, device=dev
    )
    ptr = _build.ptr
    err = lib.survival_scan_launch(
        *(ptr(x) for x in (st, alloc_node, mem, ev, tier, migrating, susp_tick,
                           surv_deadline, base, t, pressure, *masks, scratch)),
        P, N, int(airlock), float(residual), float(watermark), float(safe),
        int(t_susp), int(t_surv), _build.stream(st),
    )
    _build.check(err, "survival_scan")
    survival_scan.launches += 1
    return (pressure, *masks)


survival_scan.launches = 0
