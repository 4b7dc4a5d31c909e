"""Plain PyTorch version of the survival_scan kernel (port of the JAX ref).

  * pressure: one scatter-add of effective memory onto ``base`` (rigid +
    ambient), in probe-slot order (``index_add_`` on the CPU adds in index
    order, as the JAX reference's scatter-add does);
  * victim: lexicographic per-node argmax of ``(tier, score, slot)``: an
    integer scatter-max restricting candidates to each node's worst resident
    workload class (Airlock only), then exact scatter-max passes over
    ``(score, slot)``;
  * transition masks: elementwise on the post-victim view of the table.

State-machine codes are duplicated here so that the kernel package imports
without ``repro_torch.core``; ``core.hotpath`` checks that they agree.
"""

from __future__ import annotations

import torch

EMPTY = 0
RUNNING = 6
SUSPENDED = 7


def survival_scan_ref(
    st: torch.Tensor,  # (P,) i32 probe state-machine code
    alloc_node: torch.Tensor,  # (P,) i32 node holding the primary allocation (-1 none)
    mem: torch.Tensor,  # (P,) f32 true physical memory while resident
    ev: torch.Tensor,  # (P,) f32 static routing weight E_v,init
    tier: torch.Tensor,  # (P,) i32 workload class
    migrating: torch.Tensor,  # (P,) bool secondary-reactivation epoch
    susp_tick: torch.Tensor,  # (P,) i32 tick at which suspension began
    surv_deadline: torch.Tensor,  # (P,) i32 shared survival TTL expiry tick
    base: torch.Tensor,  # (N,) f32 rigid + ambient node memory
    t: torch.Tensor,  # () i32 current tick
    *,
    airlock: bool,
    residual: float,
    watermark: float,
    safe: float,
    t_susp: int,
    t_surv: int,
):
    """Returns ``(pressure (N,) f32, victim, resume, react, expire)``; the last
    four are (P,) bool masks, the transition masks all False without Airlock.
    Thresholds compare in float32, as the JAX reference casts them."""
    N = base.shape[0]
    P = st.shape[0]
    dev = st.device
    valid = alloc_node >= 0
    node_c = torch.clamp(alloc_node, 0, N - 1).long()
    tgt = torch.where(valid, alloc_node, N).long()

    resident = st == RUNNING
    susp = st == SUSPENDED
    mig = migrating.to(torch.bool)
    mem = mem.to(torch.float32)
    mem_eff = torch.where(
        resident, mem, torch.where(susp | (mig & valid), mem * residual, 0.0)
    )
    acc = torch.cat([base.to(torch.float32), base.new_zeros(1, dtype=torch.float32)])
    pressure = acc.index_add_(0, tgt, mem_eff)[:N]

    over = pressure[node_c] > watermark
    cand = resident & over & valid
    if airlock:
        # strict tier precedence: only each node's worst-class candidates
        btier = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
        btier.scatter_reduce_(0, tgt, torch.where(cand, tier.to(torch.int32), -1), "amax")
        cand = cand & (tier == btier[node_c])
    score = -ev.to(torch.float32) if airlock else mem
    sc = torch.where(cand, score, -torch.inf)
    best = torch.full((N + 1,), -torch.inf, dtype=torch.float32, device=dev)
    best.scatter_reduce_(0, tgt, sc, "amax")
    top = cand & (sc == best[node_c]) & torch.isfinite(sc)
    slot = torch.arange(P, dtype=torch.int32, device=dev)
    wslot = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    wslot.scatter_reduce_(
        0, torch.where(top, alloc_node, N).long(), torch.where(top, slot, -1), "amax"
    )
    victim = top & (slot == wslot[node_c])

    if not airlock:
        zeros = torch.zeros_like(victim)
        return pressure, victim, zeros, zeros.clone(), zeros.clone()

    st_rc = torch.where(victim, SUSPENDED, st)
    mig_rc = mig & ~victim
    stick_rc = torch.where(victim, t, susp_tick)

    node_ok = pressure[node_c] < safe
    glass = (st_rc == SUSPENDED) & ~mig_rc
    resume = glass & node_ok & valid
    react = glass & ~resume & ((t - stick_rc) > t_susp)
    deadline = torch.where(react, t + t_surv, surv_deadline)
    expire = (mig_rc | react) & (t > deadline) & (st_rc != EMPTY) & (st_rc != RUNNING)
    return pressure, victim, resume, react, expire
