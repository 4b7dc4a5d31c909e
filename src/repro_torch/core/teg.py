"""TEG: Thermo-Economic Gateway (§III-D, §IV-A), a port of ``repro.core.teg``.

Macroscopic probabilistic flow splitting over *Zone-level aggregates only*:

    P(z) = 2^(U_z / tau) / sum_r 2^(U_r / tau)

sampled as a Gumbel-argmax over the zone logits.
"""

from __future__ import annotations

import torch

from repro_torch.core import hotpath
from repro_torch.core.config import LaminarConfig
from repro_torch.core.draws import Draws
from repro_torch.core.state import ROUTING, SimState
from repro_torch.core.utility import unified_utility, zone_routing_logits


def compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the set entries of ``mask``, in order, in a fixed-size
    buffer filled with -1: the i-th set entry goes to position i.

    Replaces ``jnp.nonzero(mask, size=, fill_value=-1)`` without a host
    sync (``torch.nonzero`` waits for the device to learn the count): an
    inclusive cumsum gives each set entry its position, then one scatter of
    ``arange`` into a buffer with a spare row that takes what is dropped.
    """
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    keep = mask & (pos < size)
    out = pos.new_full((size + 1,), -1)  # from ``pos``: it carries a seed axis under vmap
    src = torch.arange(n, dtype=torch.int32, device=mask.device)
    out.index_put_((torch.where(keep, pos, size).long(),), src)
    return out[:size]


def scatter_rows(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``arr.at[idx].set(val, mode="drop")``: rows whose index is
    ``len(arr)`` are dropped (they land in a spare row that is cut off)."""
    n = arr.shape[0]
    buf = torch.cat([arr, arr.new_empty((1,) + tuple(arr.shape[1:]))])
    if isinstance(val, torch.Tensor):
        buf.index_put_((idx.long(),), val.to(arr.dtype))
    else:  # a Python scalar: no host-to-device copy
        buf.index_fill_(0, idx.long(), val)
    return buf[:n]


def refresh(cfg: LaminarConfig, s: SimState, plane=None) -> SimState:
    """Refresh T_global (zone aggregates) from the Z-HAF reported view.

    The gather over the zone members, the segmented reduction and the
    refresh-tick select are the ``zone_aggregate_members`` hot-path op (one
    kernel launch on CUDA); it decides from the device tick whether the tick
    is due, since deciding on the host would wait for the device.
    ``plane`` (the sharded engine's ``MeshPlane``) reduces the rank's zone
    rows and gathers the (Z,) table every tick, selected by ``torch.where``:
    ranks must all call the collective or none.
    """
    every = cfg.ticks(cfg.teg_refresh_ms)
    if plane is None:
        zS, zH = hotpath.zone_aggregate_members(
            s.rep_S, s.rep_H, s.zmember, s.zmask, s.t, s.zS, s.zH, every=every
        )
        return s._replace(zS=zS, zH=zH)
    zS, zH = plane.zone_aggregates(cfg, s)
    due = (s.t % every) == 0
    return s._replace(zS=torch.where(due, zS, s.zS), zH=torch.where(due, zH, s.zH))


def dispatch(
    cfg: LaminarConfig,
    s: SimState,
    d: Draws,
    mask: torch.Tensor,
    max_dispatch: int,
) -> SimState:
    """Route every probe in ``mask`` to a launchpad node in a sampled Zone.

    Gather-compute-scatter over at most ``max_dispatch`` slots: the i-th
    Gumbel row goes to the i-th dispatched slot.
    """
    P = s.st.shape[0]
    idx = compact(mask, max_dispatch)
    valid = idx >= 0
    scat_idx = torch.where(valid, idx, P)

    u = unified_utility(s.zS, s.zH, cfg.gamma_repulsion)
    logits = zone_routing_logits(u, cfg.teg_temperature)  # (Z,)
    zone = torch.argmax(logits[None, :] + d.gumbel, dim=-1).to(torch.int32)

    # uniform launchpad within the selected zone
    launch = s.zstart[zone] + torch.floor(
        d.launch_u * s.zcount[zone].to(torch.float32)
    ).to(torch.int32)
    launch = torch.clamp(launch, 0, cfg.num_nodes - 1)

    m = s.metrics
    return s._replace(
        st=scatter_rows(s.st, scat_idx, ROUTING),
        zone=scatter_rows(s.zone, scat_idx, zone),
        node=scatter_rows(s.node, scat_idx, launch),
        timer=scatter_rows(s.timer, scat_idx, 1),  # 1 hop
        metrics=m._replace(op_dispatch=m.op_dispatch + torch.sum(valid, dtype=torch.int32)),
    )
