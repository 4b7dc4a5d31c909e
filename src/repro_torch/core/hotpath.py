"""Hot-path kernel dispatch, a port of ``repro.core.hotpath``.

The four measured control-plane operations go through this module:
bitmap feasibility (``arbiter``: ``bitmap_fit_rounds``, every arbitration
round of the flat tick in one launch; ``bitmap_fit_rounds_blocked``, the
same on a rank's zone block of the sharded engine; ``bitmap_fit`` and
``bitmap_fit_blocked`` for one round, on no tick), utility
scoring + candidate argmax (``da``: ``utility_topk_address``, the whole
addressing step in one launch; ``utility_topk`` on scored tiles), zone
aggregation (``teg``: ``zone_aggregate_members``, the whole refresh in one
launch; ``zone_aggregate`` on gathered tiles) and the fused Airlock
survival scan (``engine``). Each forwards to its kernel package, whose
wrapper dispatches by device: a CUDA tensor launches the hand-written
Hopper kernel (or the wrapper raises), a CPU tensor takes the plain
PyTorch version. There is no configuration switch and no fallback from
one to the other.

The four entries the flat tick calls go through their custom ops
(``repro_torch::<entry>``, ``kernels.batching``): outside ``vmap`` the op
is the wrapper; under the lockstep engine's ``torch.func.vmap`` over a seed
axis it is ONE call of the entry's batched twin (one launch for all seeds
on CUDA, the plain version seed by seed on the CPU). Each of the four is a
span, ``hotpath.<entry>`` (``core.spans``).
"""

from __future__ import annotations

import torch

from repro_torch.core import state as _state
from repro_torch.core.config import LaminarConfig
from repro_torch.core.spans import span
from repro_torch.kernels.bitmap_fit import ops as _bitmap_ops
from repro_torch.kernels.survival_scan import ops as _surv_ops
from repro_torch.kernels.survival_scan import ref as _surv_ref
from repro_torch.kernels.utility_topk import ops as _topk_ops
from repro_torch.kernels.zone_aggregate import ops as _agg_ops

__all__ = [
    "bitmap_fit",
    "bitmap_fit_blocked",
    "bitmap_fit_rounds",
    "bitmap_fit_rounds_blocked",
    "survival_scan",
    "utility_topk",
    "utility_topk_address",
    "zone_aggregate",
    "zone_aggregate_members",
]

# the survival_scan kernel package hardcodes the state-machine codes to stay
# importable without repro_torch.core; fail loudly here if they ever drift
if (_surv_ref.EMPTY, _surv_ref.RUNNING, _surv_ref.SUSPENDED) != (
    _state.EMPTY,
    _state.RUNNING,
    _state.SUSPENDED,
):
    raise ImportError("survival_scan state codes out of sync with core.state")


def bitmap_fit(
    words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor
) -> torch.Tensor:
    """Per-node feasibility (int32 0/1) of each node's demand vs its words."""
    return _bitmap_ops.bitmap_fit(words, mass, contig)


def bitmap_fit_blocked(
    words: torch.Tensor, mass: torch.Tensor, contig: torch.Tensor
) -> torch.Tensor:
    """Zone-blocked feasibility: ``(Z, M, W)`` words, ``(Z, M)`` demand ->
    ``(Z, M)`` int32, one round's fit test alone; the sharded tick runs
    :func:`bitmap_fit_rounds_blocked` instead."""
    return _bitmap_ops.bitmap_fit_blocked(words, mass, contig)


def bitmap_fit_rounds(cfg: LaminarConfig, s, throttled: torch.Tensor):
    """Every one of the ``cfg.arb_rounds`` arbitration rounds of the flat tick:
    the election, the fit test and the allocation on the true words.

    Returns ``(winner (R, N), feas (R, N), alloc (R, N, W), round (P,),
    admit (P,))``: each round's winner slot (-1: none), whether it was
    admitted and the words it took; each probe's round won (-1: none) and
    admission."""
    with span("hotpath.bitmap_fit_rounds"):
        return _bitmap_ops.bitmap_fit_rounds_op(
            s.st, s.node, s.ev, s.mass, s.contig, s.free, throttled,
            rounds=cfg.arb_rounds, atoms=cfg.atoms_per_node, policy=cfg.alloc_policy,
        )


def bitmap_fit_rounds_blocked(cfg: LaminarConfig, s, throttled: torch.Tensor,
                              member: torch.Tensor, mask: torch.Tensor, local: torch.Tensor):
    """The ``cfg.arb_rounds`` arbitration rounds of the zone-sharded tick on
    one rank's ``(Zb, M)`` zone block (``member``, ``mask``; ``local`` maps
    a node to its slot in the block, -1 for another rank's), from the
    replicated probe table and words.

    Returns ``(winner (R, Zb, M), feas (R, Zb, M), alloc (R, Zb, M, W))``:
    each round's winner slot (-1: none), whether it was admitted and the
    words it took, in the blocked layout."""
    return _bitmap_ops.bitmap_fit_rounds_blocked(
        s.st, s.node, s.ev, s.mass, s.contig, s.free, throttled, member, mask, local,
        rounds=cfg.arb_rounds, atoms=cfg.atoms_per_node, policy=cfg.alloc_policy,
    )


def utility_topk(
    s_pred: torch.Tensor,
    h_pred: torch.Tensor,
    eps: torch.Tensor,
    feasible: torch.Tensor,
    gamma: float,
):
    """Best candidate per probe: (best_idx (P,), best_score (P,))."""
    return _topk_ops.utility_topk(s_pred, h_pred, eps, feasible, gamma)


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
    """One DA addressing round (``core.da.address``) for every probe with
    ``st == ADDRESSING``, reading the draws ``d`` and the true node view
    ``view``. Returns the new ``(st, node, zone, timer, patience)`` (P,) and
    the int32 counts ``(op_eval, op_bounce, fastfail)``."""
    with span("hotpath.utility_topk_address"):
        return _topk_ops.utility_topk_address_op(
            s.st, s.node, s.zone, s.timer, s.patience, s.migrating, s.mass, s.contig,
            d.cand_u, d.addr_eps, s.zstart, s.zcount, s.zone_id,
            s.rep_S, s.rep_H, s.rep_run, s.rep_t, s.dS, s.dH,
            view.s_true, view.h_true, view.run_true, s.t, **address_params(cfg),
        )


def zone_aggregate(s_gather: torch.Tensor, h_gather: torch.Tensor, mask: torch.Tensor):
    """Per-zone (mean slack, total heat) from densified node gathers."""
    return _agg_ops.zone_aggregate(s_gather, h_gather, mask)


def zone_aggregate_members(rep_S, rep_H, member, mask, t=None, zS=None, zH=None, *,
                           every: int = 1):
    """Per-zone (mean slack, total heat) of the node vectors over the
    ``(Z, M)`` zone members; given the tick ``t``, the old ``zS``, ``zH``
    are kept where ``t % every != 0`` (decided on the device)."""
    with span("hotpath.zone_aggregate_members"):
        return _agg_ops.zone_aggregate_members_op(rep_S, rep_H, member, mask, t, zS, zH,
                                                  every=every)


def survival_scan(cfg: LaminarConfig, s):
    """Fused per-tick survival decision over the probe table (§III-G/H/I).

    Takes the full ``SimState`` and returns
    ``(pressure (N,), victim, resume, react, expire)``; the transition masks
    are empty when ``cfg.airlock`` is off.
    """
    mc = cfg.memory
    with span("hotpath.survival_scan"):
        return _surv_ops.survival_scan_op(
            s.st,
            s.alloc_node,
            s.mem,
            s.ev,
            s.tier,
            s.migrating,
            s.susp_tick,
            s.surv_deadline,
            s.rigid_mem + s.amb,
            s.t,
            airlock=cfg.airlock,
            residual=mc.suspended_residual,
            watermark=mc.high_watermark if cfg.airlock else mc.kill_watermark,
            safe=mc.safe_watermark,
            t_susp=cfg.ticks(cfg.t_susp_ms),
            t_surv=cfg.ticks(cfg.t_surv_ms),
        )
