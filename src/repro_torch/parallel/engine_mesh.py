"""Zone-sharded scale-out engine on ``torch.distributed``.

A port of ``repro.parallel.engine_mesh``. Zones are Laminar's natural
independence boundary (TEG splits flow over zone aggregates only; probing
and arbitration are in-zone or node-local), so the zone axis is the shard
dimension. Each rank of a process group runs the same tick on its own
device:

  sharded     the O(N * A) node-bitmap pipeline (bit-plane unpack, max-run
              scans, the arbitration rounds' election, feasibility and atom
              allocation): each rank computes its block of ``ceil(Z / D)``
              padded zone rows (``MeshPlane``), the rounds in one launch of
              ``bitmap_fit_rounds_blocked`` and the zone sums in one of
              ``zone_aggregate_members``.

  replicated  the probe table and every O(N) float vector. Every rank draws
              the same random values (same seed or same recorded draws) and
              runs the same deterministic ops, so all ranks hold identical
              copies.

  exchanged   per tick, five ``all_gather_into_tensor`` calls (one
              collective into one buffer each): (a) the (Z,) zone-aggregate
              table (zS, zH) and (b) the per-node results of the sharded
              pipeline: s_true, run_true, and one int32 tensor of every
              round's winner slot, feasibility flag and allocation words.

With any group size the sharded engine equals the flat engine bit for bit:
every cross-rank value is an exact gather of rows computed the same way the
flat engine computes them, and no reduction crosses a rank. Unlike the JAX
package, the zone-aggregate exchange runs every tick (its result is kept on
refresh ticks), so no rank branches on a device value.

The caller owns the process group: ``torch.distributed.init_process_group``
with one rank per device (gloo on the CPU, NCCL on CUDA), then
``ZoneShardedEngine(cfg, num_devices=world_size, device=...)`` on every rank.
``repro_torch.parallel.local.run_local`` does this for D processes on one
host.

The run is compiled as the flat engine's is (``core.scan``, the reference's
``jax.jit(shard_map(lax.scan))``): on CUDA every rank captures one tick,
its five NCCL collectives included, as a CUDA graph once per zone geometry
and replays it; on the CPU (gloo) the same in-place body runs in a loop.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import arbiter, bitmap, hotpath, zhaf
from repro_torch.core.config import LaminarConfig
from repro_torch.core.engine import TS_FIELDS, LaminarEngine, make_step
from repro_torch.core.scan import scan
from repro_torch.core.state import SimState, count, init_numpy, unpack_zoned

__all__ = ["MeshPlane", "ZoneShardedEngine", "traffic_model", "zone_block", "zone_group"]


def zone_group(num_devices: int | None = None, group=None) -> int:
    """Check the zone axis against the initialized process group; returns
    its size. ``num_devices`` (default: the group's size) must equal it."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "the zone-sharded engine needs an initialized torch.distributed "
            "process group (one rank per device)"
        )
    world = dist.get_world_size(group)
    d = world if num_devices is None else int(num_devices)
    if d != world:
        raise ValueError(f"requested {d} devices, the process group has {world} ranks")
    return d


def zone_block(zmember: torch.Tensor, zmask: torch.Tensor, rank: int, num_ranks: int,
               num_nodes: int):
    """Rank ``rank``'s block of the zone rows, padded to a multiple of
    ``num_ranks`` rows (padding rows have no valid slot): ``member`` (Zb, M)
    int32 node of each slot, ``mask`` (Zb, M) float32 validity, and
    ``local`` (N,) int32, each node's slot in the flattened block, -1 for a
    node of another rank. ``local`` is built from the mask alone: padding
    slots point at node 0 in ``zmember``."""
    Z, M = zmember.shape
    Zb = -(-Z // num_ranks)
    dev = zmember.device
    member = torch.zeros((Zb * num_ranks, M), dtype=torch.int32, device=dev)
    mask = torch.zeros((Zb * num_ranks, M), dtype=zmask.dtype, device=dev)
    member[:Z] = zmember
    mask[:Z] = zmask
    rows = slice(rank * Zb, (rank + 1) * Zb)
    member, mask = member[rows].contiguous(), mask[rows].contiguous()
    # padding slots scatter to a spare entry that is cut off
    tgt = torch.where(mask > 0, member, num_nodes).reshape(-1).long()
    local = torch.full((num_nodes + 1,), -1, dtype=torch.int32, device=dev)
    local.index_copy_(0, tgt, torch.arange(Zb * M, dtype=torch.int32, device=dev))
    return member, mask, local[:num_nodes].contiguous()


class MeshPlane:
    """Node-plane strategy: this rank's zone block of the bitmap pipeline.

    Built once per run from the zone geometry. The state arrives replicated;
    the plane computes on its own ``(Zb, M)`` rows and gathers the per-node
    results back to the replicated flat layout the probe plane reads.
    """

    def __init__(
        self,
        cfg: LaminarConfig,
        zmember: torch.Tensor,
        zmask: torch.Tensor,
        group=None,
    ):
        self.cfg = cfg
        self.group = group
        self.D = dist.get_world_size(group)
        rank = dist.get_rank(group)
        Z, M = zmember.shape
        self.Z, self.Zb, self.M = Z, -(-Z // self.D), M
        # (Zb, M) int32 node index per slot, (Zb, M) f32 validity, (N,) int32
        # node -> slot in this block (-1: another rank's)
        self.mem_l, self.msk_l, self.local = zone_block(zmember, zmask, rank, self.D,
                                                        cfg.num_nodes)
        self.valid_w = (self.msk_l > 0)[..., None]  # (Zb, M, 1)
        # node n's slot in the gathered (Zb * D * M,) rows: unpack_zoned of
        # the slot numbers, so a gather is the same as unpack_zoned
        slots = torch.arange(self.Zb * self.D * M, device=zmember.device).reshape(-1, M)
        self.slot_of = unpack_zoned(slots, zmember, zmask, cfg.num_nodes)

    # ---- blocked-layout plumbing ---------------------------------------

    def _gather(self, x_l: torch.Tensor) -> torch.Tensor:
        """Gather the ranks' (Zb, ...) blocks into (D * Zb, ...): one
        collective into one buffer, rank r's block at rows r * Zb."""
        out = x_l.new_empty((self.D * x_l.shape[0],) + tuple(x_l.shape[1:]))
        dist.all_gather_into_tensor(out, x_l.contiguous(), group=self.group)
        return out

    def _to_flat(self, x_l: torch.Tensor) -> torch.Tensor:
        """Local (Zb, M, ...) rows -> flat replicated (N, ...)."""
        xb = self._gather(x_l)
        return xb.reshape((-1,) + tuple(xb.shape[2:]))[self.slot_of]

    # ---- the three node-plane hooks ------------------------------------

    def build_view(self, cfg: LaminarConfig, s: SimState) -> zhaf.NodeView:
        """Blocked view build: the true free atoms and longest free run of
        the local rows, gathered (a NodeView with ``bits=None``)."""
        words_l = torch.where(self.valid_w, s.free[self.mem_l], 0).reshape(self.Zb * self.M, -1)
        bits_l = bitmap.unpack_bits(words_l, cfg.atoms_per_node)
        s_true_l = torch.sum(bits_l, dim=-1).to(torch.float32)
        run_l = bitmap.max_run(bits_l).to(torch.float32)
        s_true = self._to_flat(s_true_l.reshape(self.Zb, self.M))
        run_true = self._to_flat(run_l.reshape(self.Zb, self.M))
        h_true = zhaf.node_heat(cfg, s).to(torch.float32)
        return zhaf.NodeView(None, s_true, h_true, run_true)

    def arb_rounds(self, cfg: LaminarConfig, s: SimState, throttled: torch.Tensor) -> SimState:
        """The tick's ``cfg.arb_rounds`` admission rounds: the same state as
        the flat tick's ``arbiter.arbitrate_rounds``.

        One ``bitmap_fit_rounds_blocked`` (one launch on the card) elects,
        tests and allocates every round on the local zone block; one gather
        brings each node's (winner, feasibility, words) of every round to
        all ranks, as one int32 tensor; each probe's transition is applied
        once, for the round it won: probe p won round r iff it is the
        winner of round r at its node."""
        R, N, P = cfg.arb_rounds, cfg.num_nodes, s.st.shape[0]
        winner, feas, alloc = hotpath.bitmap_fit_rounds_blocked(
            cfg, s, throttled, self.mem_l, self.msk_l, self.local)
        W = alloc.shape[-1]
        rows = torch.cat([winner[..., None], feas[..., None].to(torch.int32), alloc], dim=-1)
        rows = rows.permute(1, 2, 0, 3).reshape(self.Zb, self.M, R * (W + 2))
        flat = self._to_flat(rows).reshape(N, R, W + 2)  # (N, R, winner | feas | words)
        mine = flat[torch.clamp(s.node, 0, N - 1)]  # (P, R, W + 2): each probe's node
        slot = torch.arange(P, dtype=torch.int32, device=s.st.device)
        hit = mine[:, :, 0] == slot[:, None]  # (P, R): won round r
        won = hit.any(dim=1)
        admit = torch.any(hit & (mine[:, :, 1] != 0), dim=1)
        # at most one round per probe, and the rounds take disjoint atoms:
        # int32 sums of the words are ORs
        probe_alloc = torch.sum(torch.where(hit[..., None], mine[:, :, 2:], 0), dim=1,
                                dtype=torch.int32)
        taken = torch.sum(flat[:, :, 2:], dim=1, dtype=torch.int32)
        return arbiter._admissions(cfg, s, won, admit, probe_alloc, s.free & ~taken,
                                   R * count(throttled))

    def zone_aggregates(self, cfg: LaminarConfig, s: SimState):
        """Local zone rows through the zone_aggregate_members kernel, then
        the O(Z) aggregate-table gather (the modelled control-plane
        exchange)."""
        zS_l, zH_l = hotpath.zone_aggregate_members(s.rep_S, s.rep_H, self.mem_l, self.msk_l)
        return self._gather(zS_l)[: self.Z], self._gather(zH_l)[: self.Z]


def traffic_model(
    cfg: LaminarConfig, num_zones: int, num_devices: int, max_zone: int | None = None
) -> Dict[str, float]:
    """Per-tick cross-shard bytes of the sharded tick, by category.

    The same arithmetic as the JAX package's ``traffic_model``: the bytes the
    design moves, not a measurement of this engine's exchange. The port's
    exchange of the rounds also moves each round's int32 winner slot (R of
    them a slot), in one gather of winner, feasibility and words together;
    the model, kept equal to the reference's, leaves them out.
    ``control_plane_bytes_per_tick`` is the modelled Laminar control plane,
    the (zS, zH) table once per refresh interval: O(num_zones) floats.
    ``sim_sync_bytes_per_tick`` is the simulator-fidelity exchange (per-node
    results feeding the replicated probe plane), O(num_nodes). An
    ``all_gather`` of an X-byte array moves X * (D - 1) bytes in all.
    """
    D = int(num_devices)
    peers = max(D - 1, 0)
    refresh_every = cfg.ticks(cfg.teg_refresh_ms)
    # (zS, zH): 2 float32 per zone, once per refresh interval
    ctrl = 2 * 4 * num_zones * peers / refresh_every

    M = int(max_zone) if max_zone else cfg.zone_size
    Zb = -(-num_zones // D)
    slots = Zb * D * M  # padded blocked slots actually transferred
    W = max(1, (cfg.atoms_per_node + 31) // 32)
    view_bytes = 2 * 4 * slots  # s_true + run_true, float32
    round_bytes = (4 * W + 1) * slots  # alloc words (uint32) + feas (bool)
    sync = (view_bytes + cfg.arb_rounds * round_bytes) * peers
    return {
        "num_zones": int(num_zones),
        "num_devices": D,
        "control_plane_bytes_per_tick": float(ctrl),
        "sim_sync_bytes_per_tick": float(sync),
    }


def zone_digest(s: SimState) -> str:
    """A digest of the zone geometry (``zmember``, ``zmask``'s float32 bits):
    the one host read of a sharded run, one copy made before its first
    tick."""
    geometry = torch.cat([s.zmember.reshape(-1), s.zmask.reshape(-1).view(torch.int32)])
    return hashlib.sha1(geometry.cpu().numpy().tobytes()).hexdigest()


class ZoneShardedEngine(LaminarEngine):
    """:class:`LaminarEngine` whose tick runs the zone-sharded node plane.

    Same ``run`` / ``run_batch`` / ``simulate`` surface. Every rank of the
    process group constructs it and calls the same methods with the same
    arguments; ``device`` is this rank's device (default ``"cuda"``, the
    current CUDA device). ``run_batch`` runs the seeds one after another,
    as the JAX package's sharded engine does.

    :meth:`simulate` is the compiled run (``core.scan``), as the flat
    engine's: on CUDA one tick is captured as a CUDA graph, its five NCCL
    collectives inside it, and replayed; on the CPU (gloo) the same body runs
    in a loop. A captured tick is kept per zone geometry (a digest of
    ``zmember`` / ``zmask``, taken once a run), since the plane's block
    tables are built from it and two seeds may share shapes but not zones.
    """

    def __init__(
        self,
        cfg: LaminarConfig,
        num_devices: int | None = None,
        device="cuda",
        group=None,
    ):
        super().__init__(cfg, device=device)
        self.group = group
        self.num_devices = zone_group(num_devices, group)

    def _plane(self, s: SimState) -> MeshPlane:
        return MeshPlane(self.cfg, s.zmember, s.zmask, self.group)

    def simulate(
        self, s: SimState, draws, num_ticks: int, scenario=None
    ) -> Tuple[SimState, torch.Tensor]:
        """Run ``num_ticks`` sharded ticks from ``s`` (``draws.tick(t)`` each
        tick's values) through ``core.scan``: on CUDA the tick is captured
        the first time this engine sees its config and zone geometry and
        replayed every tick after. Returns the final state and the (T, 11)
        int32 timeseries, still on the device. Draws made for another
        scenario are refused."""
        cfg = self._checked_config(draws, scenario)
        if num_ticks == 0:
            return s, torch.zeros((0, len(TS_FIELDS)), dtype=torch.int32, device=s.st.device)
        return scan(make_step(cfg, plane=self._plane(s)), s, draws, num_ticks,
                    cache=self._compiled, key=(cfg, "mesh", zone_digest(s)))

    def run_batch(
        self,
        seeds: Sequence[int],
        num_ticks: int | None = None,
        scenario=None,
        draws: Optional[Sequence[Any]] = None,
    ) -> List[Dict[str, Any]]:
        """One ``summarize()`` dict per seed, the seeds one after another
        from ``seeds[0]``'s initial state (its geometry and ``lam``), as the
        JAX package's sharded engine runs them: the tick's collectives do
        not go under ``vmap``. ``draws``: one provider per seed."""
        seeds, draws, nt = self._batch_args(seeds, num_ticks, draws)
        s0, lam = self.init(seeds[0])
        outs = []
        for i, sd in enumerate(seeds):
            d = draws[i] if draws is not None else self.draws(
                lam, s0.zstart.shape[0], sd, scenario)
            final, ts = self.simulate(s0, d, nt, scenario)
            outs.append(self._summary(final, ts.cpu().numpy(), lam, sd))
        return outs

    def traffic(self, seed: int = 0) -> Dict[str, float]:
        """Traffic model for this engine's actual zone geometry."""
        Z, M = init_numpy(self.cfg, seed)["zmember"].shape
        return traffic_model(self.cfg, Z, self.num_devices, max_zone=M)
