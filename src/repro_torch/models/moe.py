"""Mixture-of-Experts with capacity-bounded dispatch: a port of
``repro.models.moe``.

Two routers:

  * ``topk``    — standard top-k token-choice routing; tokens overflowing an
    expert's capacity are dropped (combine weight 0).
  * ``laminar`` — the paper's probe-first discipline applied to MoE routing:
    experts are nodes, residual capacity is Slack, per-round assignment
    pressure is Heat. Router logits are tempered by a heat-repulsion term,
    and tokens that overflow an expert are *bounced* to their next-best
    expert for a bounded number of rounds instead of being dropped.

Dispatch is sort-free: a one-hot assignment per round, positions by a
prefix sum, tokens added into (E, C, d) expert buffers, a batched expert
FFN, a weighted combine.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core import floatops
from repro_torch.models import common as cm
from repro_torch.models import regions
from repro_torch.models.common import ArchConfig, MoEConfig, Params


class Pick(NamedTuple):
    """One routing round's choice for every token."""

    expert: torch.Tensor  # (T,) int64
    kept: torch.Tensor  # (T,) bool: granted a slot under the capacity
    pos: torch.Tensor  # (T,) int32 slot in the expert's buffer
    weight: torch.Tensor  # (T,) float32 combine weight, 0 where not kept


def init_moe_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    assert cfg.moe is not None
    mc = cfg.moe
    dt = cfg.param_dtype
    E, d, f = mc.num_experts, cfg.d_model, mc.d_ff_expert
    return {
        "router": cm.dense_init(gen, d, E, torch.float32),
        "w_gate": cm.normal(gen, (E, d, f), 1.0 / d**0.5, dt),
        "w_up": cm.normal(gen, (E, d, f), 1.0 / d**0.5, dt),
        "w_down": cm.normal(gen, (E, f, d), 1.0 / f**0.5, dt),
    }


def _capacity(mc: MoEConfig, n_tokens: int) -> int:
    c = int(mc.capacity_factor * n_tokens * mc.top_k / mc.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0 in log2(T) doubling steps
    (Hillis-Steele), the associative-scan formulation; integer sums, so it
    equals ``cumsum`` exactly."""
    out = x
    step = 1
    while step < x.shape[0]:
        out = torch.cat([out[:step], out[step:] + out[:-step]], dim=0)
        step *= 2
    return out


def _assign_round(
    scores: torch.Tensor,  # (T, E) remaining router scores (-inf = unavailable)
    used: torch.Tensor,  # (E,) slots already taken
    cap: int,
    need: torch.Tensor,  # (T,) tokens still needing a slot this round
    assoc_scan: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy one-choice assignment with capacity. Returns
    (expert (T,), kept (T,), pos (T,), used')."""
    e = torch.argmax(scores, dim=-1)  # the lowest index among equal maxima
    ok = need & torch.isfinite(torch.amax(scores, dim=-1))
    onehot = F.one_hot(e, scores.shape[1]).to(torch.int32) * ok[:, None]
    incl = _prefix_sum(onehot) if assoc_scan else torch.cumsum(onehot, dim=0, dtype=torch.int32)
    pos_in = incl - onehot
    pos = torch.sum(pos_in * onehot, dim=-1, dtype=torch.int32) + used[e]
    fits = pos < cap
    kept = ok & fits
    used = used + torch.sum(onehot * fits[:, None].to(torch.int32), dim=0, dtype=torch.int32)
    return e, kept, pos, used


def route(p: Params, cfg: ArchConfig, xt: torch.Tensor):
    """Router and assignment rounds for tokens ``xt`` (T, d). Returns the
    rounds' picks, the capacity C, the router probabilities and the slots
    each token was granted."""
    mc = cfg.moe
    T = xt.shape[0]
    E = mc.num_experts
    C = _capacity(mc, T)

    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)

    if mc.router == "laminar":
        # heat repulsion: experts popular in this batch get tempered logits.
        # The division by a device tensor rounds once on CUDA too (PyTorch
        # multiplies by the reciprocal of a host scalar there); log2 as XLA
        # computes it: its log times the float32 reciprocal of ln 2
        n = torch.full((), float(max(T, 1)), dtype=torch.float32, device=xt.device)
        load = torch.sum(probs, dim=0) / n  # (E,) soft load
        log2 = floatops.log(1.0 + load * E) * floatops.recip(floatops.f32(math.log(2.0)))
        logits = logits - mc.laminar_gamma * log2[None, :]
        probs = torch.softmax(logits, dim=-1)

    n_rounds = mc.top_k + (mc.laminar_bounces if mc.router == "laminar" else 0)

    scores = logits
    used = torch.zeros((E,), dtype=torch.int32, device=xt.device)
    picks: List[Pick] = []
    granted = torch.zeros((T,), dtype=torch.int32, device=xt.device)
    for _ in range(n_rounds):
        need = granted < mc.top_k
        e, kept, pos, used = _assign_round(scores, used, C, need, assoc_scan=cfg.moe_assoc_scan)
        w = torch.gather(probs, 1, e[:, None])[:, 0]
        picks.append(Pick(e, kept, pos, torch.where(kept, w, 0.0)))
        granted = granted + kept.to(torch.int32)
        # mask the chosen expert for the next round; a *dropped* token under
        # the laminar router keeps searching (bounded bounce), under top-k it
        # simply moves to its next expert (same as classic top-k order)
        avail = need & torch.isfinite(torch.amax(scores, dim=-1))
        scores = torch.where(F.one_hot(e, E).bool() & avail[:, None], -torch.inf, scores)
    return picks, C, probs, granted


def expert_parallel(x, cfg: ArchConfig):
    """Under ``cfg.moe_ep_constraint`` and a mesh with a "model" axis, the
    DTensor ``x`` (experts first) pinned to experts over "model" and
    replicated over the other axes, the reference's ``PS("model", None,
    None)``: the expert matmuls then stay on the expert shard. The values
    do not change. Otherwise ``x`` as it is."""
    mesh = x.device_mesh
    if not cfg.moe_ep_constraint or "model" not in mesh.mesh_dim_names:
        return x
    return x.redistribute(mesh, tuple(Shard(0) if n == "model" else Replicate()
                                      for n in mesh.mesh_dim_names))


def moe_ffn(p: Params, cfg: ArchConfig, x: torch.Tensor):
    """x: (B, S, d) -> (B, S, d); returns (out, aux) with load-balance stats.

    Under a mesh (a DTensor ``x``) the routing, the dispatch into the
    buffers and the combine are a local region on every rank's copy of all
    B * S tokens (the capacity is the whole batch's, as the reference's);
    the expert FFN between them stays DTensor ops on the sharded weights
    (its input and output pinned to experts over "model" under
    ``moe_ep_constraint``, :func:`expert_parallel`), and the output goes
    back to batch over the DP axes."""
    assert cfg.moe is not None
    mc = cfg.moe
    cd = cfg.compute_dtype
    B, S, d = x.shape
    T = B * S
    mesh = regions.mesh_of(x)
    router = p["router"]
    if mesh is not None:
        rep = regions.replicated(mesh)
        x = regions.local(x, mesh, rep)
        router = regions.param(router, mesh, rep)
    xt = x.reshape(T, d)
    E = mc.num_experts
    picks, C, probs, granted = route({"router": router}, cfg, xt)

    # ---- dispatch: tokens into (E, C, d) buffers; a dropped token goes to
    # the spare row E * C, which is cut off
    buf = torch.zeros((E * C + 1, d), dtype=cd, device=x.device)
    xc = xt.to(cd)
    for pk in picks:
        idx = torch.where(pk.kept, pk.expert * C + torch.clamp(pk.pos, max=C - 1), E * C)
        buf.index_add_(0, idx, xc)
    buf = buf[: E * C].reshape(E, C, d)
    if mesh is not None:
        buf = expert_parallel(regions.wrap(buf, mesh, rep), cfg)

    # ---- expert FFN (batched over experts) --------------------------------
    g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(cd))
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(cd))
    h = cm.silu(g) * u
    y = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(cd))
    if mesh is not None:  # gathered before the flatten, which DTensor cannot split
        y = expert_parallel(y, cfg)
        y = regions.local(y, mesh, rep)
    y = y.reshape(E * C, d)

    # ---- combine: weighted gather back ------------------------------------
    out = torch.zeros((T, d), dtype=cd, device=x.device)
    total_w = torch.zeros((T,), dtype=torch.float32, device=x.device)
    for pk in picks:
        idx = torch.where(pk.kept, pk.expert * C + torch.clamp(pk.pos, max=C - 1), 0)
        contrib = y[idx] * pk.weight[:, None].to(cd)
        out = out + torch.where(pk.kept[:, None], contrib, 0)
        total_w = total_w + pk.weight
    out = out / torch.clamp(total_w, min=1e-9)[:, None].to(cd)

    dropped = torch.sum((granted < mc.top_k).to(torch.int32) * (mc.top_k - granted),
                        dtype=torch.int32)
    aux = {
        "moe_dropped_slots": dropped,
        "moe_load": torch.sum(F.one_hot(torch.argmax(probs, -1), E).float(), dim=0),
    }
    out = out.reshape(B, S, d)
    if mesh is not None:
        out = regions.wrap(out, mesh, rep).redistribute(mesh, regions.placements(mesh, B, 0))
    return out, aux
