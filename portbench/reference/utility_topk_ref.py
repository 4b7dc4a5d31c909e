"""Plain PyTorch versions of the utility_topk kernels (port of the JAX ref).

``utility_topk_ref`` is the TPU kernel's function: score every candidate of
a probe row and take the best. ``utility_topk_address_ref`` is the whole DA
addressing step around it (``repro.core.da.address``): candidate sampling,
the Z-HAF projection of the candidates (``repro.core.zhaf.project``), the
true view for candidate 0, feasibility, the score and argmax, the
launchpad's margin, and stay / bounce / Fast-Fail with patience.
"""

from __future__ import annotations

import torch

# module imports: core reaches this module through core.hotpath
from . import state as _state
from . import utility as _utility

NEG = -3.0e38


def utility_topk_ref(
    s_pred: torch.Tensor,
    h_pred: torch.Tensor,
    eps: torch.Tensor,
    feasible: torch.Tensor,
    gamma: float,
):
    score = (
        torch.log2(1.0 + torch.clamp(s_pred.to(torch.float32), min=0.0))
        - gamma * torch.log2(1.0 + torch.clamp(h_pred.to(torch.float32), min=0.0))
        + eps.to(torch.float32)
    )
    score = torch.where(feasible.to(torch.bool), score, NEG)
    # torch.max over a dim returns the first index of the maximum, as jnp.argmax
    val, idx = torch.max(score, dim=-1)
    return idx.to(torch.int32), val


def address_view(
    st, node, zone, timer, patience, migrating, mass, contig,
    cand_u, addr_eps, zstart, zcount, zone_id,
    rep_S, rep_H, rep_run, rep_t, dS, dH, s_true, h_true, run_true, t,
    *, sigma: float, projection: bool, tau: float, dt_ms: float, degrade_after_ms: float,
    degrade_halflife_ms: float, **_,
):
    """What every slot's addressing round evaluates, on the entry's
    arguments: ``(here, cand, s_eff, h_eff, feas, eps)``, the launchpad
    (P,), the K candidate nodes (P, K) with their projected slack and heat,
    feasibility and score noise."""
    N = rep_S.shape[0]
    # candidate 0 is the launchpad; K - 1 more sampled uniformly in the zone
    zc = torch.clamp(zcount[zone], min=1).to(torch.float32)
    cand = zstart[zone][:, None] + torch.floor(cand_u * zc[:, None]).to(torch.int32)
    cand = torch.clamp(cand, 0, N - 1)
    here = torch.clamp(node, min=0)
    cand = torch.cat([here[:, None], cand], dim=1)

    # zhaf.project: projected + degrade-adjusted view of the candidates
    r_S, r_H, r_run = rep_S[cand], rep_H[cand], rep_run[cand]
    if projection:
        s_pred = torch.clamp(r_S + tau * dS[cand], min=0.0)
        h_pred = torch.clamp(r_H + tau * dH[cand], min=0.0)
    else:
        s_pred, h_pred = r_S, r_H
    age_ms = (t - rep_t[cand]).to(torch.float32) * dt_ms
    over = torch.clamp(age_ms - degrade_after_ms, min=0.0)
    # a true division on any device (PyTorch's CUDA ops multiply a tensor by
    # the reciprocal of a Python scalar divisor)
    factor = torch.exp2(-over / torch.full_like(over, degrade_halflife_ms))
    s_eff = s_pred * factor
    h_eff = h_pred / torch.clamp(factor, min=1e-6)
    run_eff = r_run * factor
    # candidate 0 is the node the DA stands on: it is evaluated against TRUE
    # local state (the projections are fresh tensors, written in place)
    s_eff[:, 0] = s_true[here]
    h_eff[:, 0] = h_true[here]
    run_eff[:, 0] = run_true[here]
    mass_f = mass.to(torch.float32)[:, None]
    feas = torch.where(contig[:, None], run_eff >= mass_f, s_eff >= mass_f)
    return here, cand, s_eff, h_eff, feas, sigma * addr_eps


def utility_topk_address_ref(*args, **kw):
    """One bounded addressing round for every probe with ``st == ADDRESSING``.

    Arguments, in order: the probe columns (P,) ``st``, ``node``, ``zone``,
    ``timer`` int32, ``patience`` float32, ``migrating`` bool, ``mass``
    int32, ``contig`` bool; the draws ``cand_u`` (P, K - 1) and
    ``addr_eps`` (P, K) float32; zones ``zstart``, ``zcount`` (Z,) int32;
    nodes ``zone_id``, the reported ``rep_S``, ``rep_H``, ``rep_run``,
    ``rep_t`` (int32), ``dS``, ``dH`` and the true ``s_true``, ``h_true``,
    ``run_true`` (N,) float32; ``t`` the tick (int32 scalar). Keywords:
    ``gamma``, ``sigma``, ``stay_margin``, ``eval_cost``, ``bounce_cost``,
    ``fastfail_floor``, ``projection``, ``tau``, ``dt_ms``,
    ``degrade_after_ms``, ``degrade_halflife_ms`` (``hotpath.address_params``).

    Returns the new ``st``, ``node``, ``zone``, ``timer``, ``patience`` (P,)
    and the int32 counts ``(op_eval, op_bounce, fastfail)`` (3,).
    """
    st, node, zone, timer, patience, migrating = args[:6]
    zone_id = args[12]
    gamma = kw["gamma"]
    active = st == _state.ADDRESSING
    here, cand, s_eff, h_eff, feas, eps = address_view(*args, **kw)

    best, best_score = utility_topk_ref(s_eff, h_eff, eps, feas, gamma)
    any_feas = torch.any(feas, dim=1)
    target = torch.gather(cand, 1, best[:, None].long())[:, 0]

    # Controlled sub-optimality: a feasible launchpad is "sufficiently good"
    # unless a remote candidate beats it by more than stay_margin bits
    here_ok = feas[:, 0]
    here_score = torch.where(
        here_ok, _utility.unified_utility(s_eff[:, 0], h_eff[:, 0], gamma) + eps[:, 0],
        -torch.inf,
    )
    prefer_here = here_ok & (best_score <= here_score + kw["stay_margin"])
    target = torch.where(prefer_here, here, target)

    stay = active & any_feas & (target == node)
    bounce = active & any_feas & (target != node)

    patience = torch.where(active, patience - kw["eval_cost"], patience)
    patience = torch.where(bounce, patience - kw["bounce_cost"], patience)

    st_new = torch.where(stay, _state.QUEUED, st)
    st_new = torch.where(bounce, _state.BOUNCING, st_new)
    node = torch.where(bounce, target, node)
    timer = torch.where(bounce, 1, timer)  # single hop
    zone = torch.where(bounce, zone_id[target], zone)

    # Fast-Fail: patience below the floor dissipates the probe locally; a
    # migrating DA reverts to the suspended glass-state, a probe's slot is freed
    ff = active & (patience < kw["fastfail_floor"])
    st_new = torch.where(ff & migrating, _state.SUSPENDED, st_new)
    st_new = torch.where(ff & ~migrating, _state.EMPTY, st_new)

    counts = torch.stack(
        [_state.count(active), _state.count(bounce & ~ff), _state.count(ff)]
    )
    return st_new, node, zone, timer, patience, counts


