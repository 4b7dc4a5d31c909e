"""The four hot-path entries of the tick, each its plain version.

A frozen copy of the port's ``core.hotpath`` with every entry bound to the
plain PyTorch function that defines it (the ``*_ref.py`` modules beside
this one): no custom op, no kernel. The port holds its kernels to these
functions as they run on the CPU. Three run on the caller's device, where
they round as there: the arbitration rounds are integer work and float
maxima; the survival scan's one float sum adds each node's terms in slot
order on any device (``survival_scan_ref.index_add_in_order``); the
addressing's float ops are elementwise. The zone aggregation's float sums
over a zone's members take the CPU's order of summation, so it runs on
the CPU (a few kilobytes each way).
"""

from __future__ import annotations

import torch

from . import state as _state
from .bitmap_fit_ref import bitmap_fit_ref, bitmap_fit_rounds_ref
from .config import LaminarConfig
from .survival_scan_ref import EMPTY, RUNNING, SUSPENDED, survival_scan_ref
from .utility_topk_ref import utility_topk_address_ref
from .zone_aggregate_ref import zone_aggregate_members_ref

if (EMPTY, RUNNING, SUSPENDED) != (_state.EMPTY, _state.RUNNING, _state.SUSPENDED):
    raise ImportError("survival_scan state codes out of sync with state")

CPU = torch.device("cpu")


def on_cpu(fn, *args, **kw):
    """``fn`` on CPU copies of its tensor arguments; its tensor outputs (a
    tensor or a tuple of them) moved back to the device of the first."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    out = fn(*(a.to(CPU) if isinstance(a, torch.Tensor) else a for a in args), **kw)
    if isinstance(out, torch.Tensor):
        return out.to(dev)
    return tuple(o.to(dev) for o in out)


def bitmap_fit_rounds(cfg: LaminarConfig, s, throttled: torch.Tensor):
    """Every one of the ``cfg.arb_rounds`` arbitration rounds of the tick:
    ``(winner (R, N), feas (R, N), alloc (R, N, W), round (P,), admit (P,))``."""
    return bitmap_fit_rounds_ref(
        s.st, s.node, s.ev, s.mass, s.contig, s.free, throttled,
        rounds=cfg.arb_rounds, atoms=cfg.atoms_per_node, policy=cfg.alloc_policy,
    )


def address_params(cfg: LaminarConfig) -> dict:
    """The keywords ``utility_topk_address`` takes from the config."""
    return dict(
        gamma=cfg.gamma_repulsion, sigma=cfg.addr_noise_sigma, stay_margin=cfg.stay_margin,
        eval_cost=cfg.eval_cost, bounce_cost=cfg.bounce_cost,
        fastfail_floor=cfg.fastfail_floor, projection=cfg.projection,
        tau=cfg.sense_delay_ms, dt_ms=cfg.dt_ms, degrade_after_ms=cfg.degrade_after_ms,
        degrade_halflife_ms=cfg.degrade_halflife_ms,
    )


def utility_topk_address(cfg: LaminarConfig, s, d, view):
    """One DA addressing round (``da.address``) for every probe with
    ``st == ADDRESSING``, reading the draws ``d`` and the true node view
    ``view``. Returns the new ``(st, node, zone, timer, patience)`` (P,) and
    the int32 counts ``(op_eval, op_bounce, fastfail)``."""
    return utility_topk_address_ref(
        s.st, s.node, s.zone, s.timer, s.patience, s.migrating, s.mass, s.contig,
        d.cand_u, d.addr_eps, s.zstart, s.zcount, s.zone_id,
        s.rep_S, s.rep_H, s.rep_run, s.rep_t, s.dS, s.dH,
        view.s_true, view.h_true, view.run_true, s.t, **address_params(cfg),
    )


def zone_aggregate_members(rep_S, rep_H, member, mask, t=None, zS=None, zH=None, *,
                           every: int = 1):
    """Per-zone (mean slack, total heat) of the node vectors over the
    ``(Z, M)`` zone members; given the tick ``t``, the old ``zS``, ``zH``
    are kept where ``t % every != 0``."""
    return on_cpu(zone_aggregate_members_ref, rep_S, rep_H, member, mask, t, zS, zH,
                  every=every)


def survival_scan(cfg: LaminarConfig, s):
    """Fused per-tick survival decision over the probe table (§III-G/H/I):
    ``(pressure (N,), victim, resume, react, expire)``; the transition masks
    are empty when ``cfg.airlock`` is off."""
    mc = cfg.memory
    return survival_scan_ref(
        s.st, s.alloc_node, s.mem, s.ev, s.tier, s.migrating, s.susp_tick,
        s.surv_deadline, s.rigid_mem + s.amb, s.t,
        airlock=cfg.airlock,
        residual=mc.suspended_residual,
        watermark=mc.high_watermark if cfg.airlock else mc.kill_watermark,
        safe=mc.safe_watermark,
        t_susp=cfg.ticks(cfg.t_susp_ms),
        t_surv=cfg.ticks(cfg.t_surv_ms),
    )
