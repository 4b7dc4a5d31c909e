"""The yardstick's constants and counts: the card's peak and the least bytes
each piece of the tick has to move, counted from the cell's shapes.

A bound counts each input read once and each output written once, for the
whole tensor the entry is given, whatever a kernel reads again and however
much of it the traffic touches: so the same work is counted whatever
implements it. The tick's bound counts the state and the tick's draws read
once, and the new state and the series row written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at the 700 W limit

# The (seedless) tensors each hot-path entry reads, by the state's field
# names; "view.*" are the tick's true node view (three float32 (N,)), "t" the
# tick, "draws.*" the draw fields. Outputs are listed by shape below.
_F32, _I32, _BOOL = 4, 4, 1


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def entry_bytes(cfg, s, lockstep_seeds: int = 1) -> dict:
    """Bytes each hot-path entry must move a launch, for one seed's state
    ``s`` (the port's or the reference's ``SimState``) under ``cfg``, times
    ``lockstep_seeds`` (a batched launch serves every seed)."""
    N, P = cfg.num_nodes, cfg.probe_capacity
    W = s.free.shape[-1]
    R, K = cfg.arb_rounds, cfg.candidate_k
    Z, M = s.zmember.shape[-2:]
    f = {name: _nbytes(getattr(s, name)) for name in s._fields if name != "metrics"}
    t = _nbytes(s.t)

    survival_in = sum(f[k] for k in ("st", "alloc_node", "mem", "ev", "tier", "migrating",
                                     "susp_tick", "surv_deadline")) + N * _F32 + t
    survival_out = N * _F32 + 4 * P * _BOOL
    rounds_in = sum(f[k] for k in ("st", "node", "ev", "mass", "contig", "free")) + N * _BOOL
    rounds_out = R * N * (_I32 + _BOOL + W * _I32) + P * (_I32 + _BOOL)
    address_in = (sum(f[k] for k in ("st", "node", "zone", "timer", "patience", "migrating",
                                     "mass", "contig", "zstart", "zcount", "zone_id", "rep_S",
                                     "rep_H", "rep_run", "rep_t", "dS", "dH"))
                  + P * (2 * K - 1) * _F32 + 3 * N * _F32 + t)
    address_out = sum(f[k] for k in ("st", "node", "zone", "timer", "patience")) + 3 * _I32
    members_in = f["rep_S"] + f["rep_H"] + Z * M * (_I32 + _BOOL) + t + f["zS"] + f["zH"]
    members_out = f["zS"] + f["zH"]
    out = {
        "survival_scan": survival_in + survival_out,
        "bitmap_fit_rounds": rounds_in + rounds_out,
        "utility_topk_address": address_in + address_out,
        "zone_aggregate_members": members_in + members_out,
    }
    return {k: v * lockstep_seeds for k, v in out.items()}


def draw_bytes(cfg, zones: int, max_dispatch: int) -> int:
    """Bytes of one seed's draws of a tick (``Draws``' fields)."""
    N, P = cfg.num_nodes, cfg.probe_capacity
    n, K, D = cfg.max_arrivals_per_tick, cfg.candidate_k, max_dispatch
    per_node = 5 * N * _F32  # memory noise, bursts, report loss and jitter
    arrivals = _I32 + 10 * n * _F32 + 2 * n * _F32  # count, the arrival fields, overclaim
    probes = P * _F32 + P * (2 * K - 1) * _F32  # move loss, candidates, symmetry breaking
    dispatch = D * zones * _F32 + D * _F32  # gumbel, launchpads
    disruption = 2 * _F32 if cfg.scenario.disruption.enabled else 0
    return per_node + arrivals + probes + dispatch + disruption


def tick_bytes(cfg, s, zones: int, max_dispatch: int, series_row: int,
               lockstep_seeds: int = 1) -> int:
    """The least bytes a tick moves: one seed's state ``s`` read and written
    once, its draws read once and its series row written once, times the
    seeds of a lockstep tick."""
    state = sum(_nbytes(x) for x in _leaves(s))
    return (2 * state + draw_bytes(cfg, zones, max_dispatch) + series_row * _I32) * lockstep_seeds


def _leaves(s):
    for name in s._fields:
        x = getattr(s, name)
        if name == "metrics":
            yield from x
        else:
            yield x
