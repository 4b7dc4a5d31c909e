"""Hot-path kernel dispatch, a port of ``repro.core.hotpath``.

The four measured control-plane operations go through this module:
bitmap feasibility (``arbiter``; ``bitmap_fit_blocked`` for the zone
blocks of the sharded engine), utility scoring + candidate argmax
(``da``), zone aggregation (``teg``) and the fused Airlock survival scan
(``engine``). Each forwards to its kernel package, whose wrapper dispatches
by device: a CUDA tensor launches the hand-written Hopper kernel (or the
wrapper raises), a CPU tensor takes the plain PyTorch version. There is no
configuration switch and no fallback from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.core import state as _state
from repro_torch.core.config import LaminarConfig
from repro_torch.kernels.bitmap_fit import ops as _bitmap_ops
from repro_torch.kernels.survival_scan import ops as _surv_ops
from repro_torch.kernels.survival_scan import ref as _surv_ref
from repro_torch.kernels.utility_topk import ops as _topk_ops
from repro_torch.kernels.zone_aggregate import ops as _agg_ops

__all__ = [
    "bitmap_fit",
    "bitmap_fit_blocked",
    "survival_scan",
    "utility_topk",
    "zone_aggregate",
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
    ``(Z, M)`` int32; the zone-sharded engine's entry for its zone block."""
    return _bitmap_ops.bitmap_fit_blocked(words, mass, contig)


def utility_topk(
    s_pred: torch.Tensor,
    h_pred: torch.Tensor,
    eps: torch.Tensor,
    feasible: torch.Tensor,
    gamma: float,
):
    """Best candidate per probe: (best_idx (P,), best_score (P,))."""
    return _topk_ops.utility_topk(s_pred, h_pred, eps, feasible, gamma)


def zone_aggregate(s_gather: torch.Tensor, h_gather: torch.Tensor, mask: torch.Tensor):
    """Per-zone (mean slack, total heat) from densified node gathers."""
    return _agg_ops.zone_aggregate(s_gather, h_gather, mask)


def survival_scan(cfg: LaminarConfig, s):
    """Fused per-tick survival decision over the probe table (§III-G/H/I).

    Takes the full ``SimState`` and returns
    ``(pressure (N,), victim, resume, react, expire)``; the transition masks
    are empty when ``cfg.airlock`` is off.
    """
    mc = cfg.memory
    return _surv_ops.survival_scan(
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
