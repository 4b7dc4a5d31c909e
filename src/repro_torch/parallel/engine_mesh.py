"""Zone-sharded scale-out engine on ``torch.distributed``.

A port of ``repro.parallel.engine_mesh``. Zones are Laminar's natural
independence boundary (TEG splits flow over zone aggregates only; probing
and arbitration are in-zone or node-local), so the zone axis is the shard
dimension. Each rank of a process group runs the same tick on its own
device:

  sharded     the O(N * A) node-bitmap pipeline (bit-plane unpack, max-run
              scans, per-winner feasibility and atom allocation, word
              packing): each rank computes its block of ``ceil(Z / D)`` padded
              zone rows (``MeshPlane``), through the same hot-path kernels as
              the flat engine (``bitmap_fit_blocked``, ``zone_aggregate``).

  replicated  the probe table and every O(N) float vector. Every rank draws
              the same random values (same seed or same recorded draws) and
              runs the same deterministic ops, so all ranks hold identical
              copies.

  exchanged   per tick, ``all_gather``s of (a) the (Z,) zone-aggregate table
              (zS, zH) and (b) the per-node results of the sharded pipeline
              (s_true / run_true and each round's allocation words and
              feasibility flags).

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
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.core import bitmap, hotpath, zhaf
from repro_torch.core.config import LaminarConfig
from repro_torch.core.engine import LaminarEngine
from repro_torch.core.state import SimState, init_numpy, unpack_zoned

__all__ = ["MeshPlane", "ZoneShardedEngine", "traffic_model", "zone_group"]


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
        Zb = -(-Z // self.D)
        dev = zmember.device
        # pad the zone rows to Zb * D (padding rows have no valid slot) and
        # keep this rank's slice
        member = torch.zeros((Zb * self.D, M), dtype=zmember.dtype, device=dev)
        mask = torch.zeros((Zb * self.D, M), dtype=zmask.dtype, device=dev)
        member[:Z] = zmember
        mask[:Z] = zmask
        rows = slice(rank * Zb, (rank + 1) * Zb)
        self.Z, self.Zb, self.M = Z, Zb, M
        self.mem_l = member[rows].long()  # (Zb, M) node index per slot
        self.msk_l = mask[rows].contiguous()  # (Zb, M) f32 validity
        self.valid = (self.msk_l > 0).reshape(-1)  # (Zb * M,)
        self.valid_w = (self.msk_l > 0)[..., None]  # (Zb, M, 1)
        # node n's slot in the gathered (Zb * D * M,) rows: unpack_zoned of
        # the slot numbers, so a gather is the same as unpack_zoned
        slots = torch.arange(Zb * self.D * M, device=dev).reshape(Zb * self.D, M)
        self.slot_of = unpack_zoned(slots, zmember, zmask, cfg.num_nodes)

    # ---- blocked-layout plumbing ---------------------------------------

    def _gather(self, x_l: torch.Tensor) -> torch.Tensor:
        """all_gather the ranks' (Zb, ...) blocks into (D * Zb, ...)."""
        out = torch.empty((self.D,) + tuple(x_l.shape), dtype=x_l.dtype, device=x_l.device)
        dist.all_gather(list(out.unbind(0)), x_l.contiguous(), group=self.group)
        return out.reshape((self.D * x_l.shape[0],) + tuple(x_l.shape[1:]))

    def _to_flat(self, x_l: torch.Tensor) -> torch.Tensor:
        """Local (Zb, M, ...) rows -> flat replicated (N, ...)."""
        xb = self._gather(x_l)
        return xb.reshape((-1,) + tuple(xb.shape[2:]))[self.slot_of]

    def _local_words(self, s: SimState) -> torch.Tensor:
        """(Zb, M, W) free words of the local rows; padding slots zeroed."""
        return torch.where(self.valid_w, s.free[self.mem_l], 0)

    # ---- the three node-plane hooks ------------------------------------

    def build_view(self, cfg: LaminarConfig, s: SimState):
        """Blocked view build; returns (NodeView with ``bits=None``, the
        local (Zb * M, A) bit plane threaded across the arbitration rounds)."""
        words_l = self._local_words(s).reshape(self.Zb * self.M, -1)
        bits_l = bitmap.unpack_bits(words_l, cfg.atoms_per_node)
        s_true_l = torch.sum(bits_l, dim=-1).to(torch.float32)
        run_l = bitmap.max_run(bits_l).to(torch.float32)
        s_true = self._to_flat(s_true_l.reshape(self.Zb, self.M))
        run_true = self._to_flat(run_l.reshape(self.Zb, self.M))
        h_true = zhaf.node_heat(cfg, s).to(torch.float32)
        return zhaf.NodeView(None, s_true, h_true, run_true), bits_l

    def alloc_round(self, cfg: LaminarConfig, s: SimState, bits_l, ws, has_w):
        """One admission round's bitmap math on the local zone block.

        The flat path's op sequence per local row (feasibility kernel, class
        allocation, word packing); padding rows are forced infeasible. Only
        the packed words and the feasibility flags are gathered."""
        Zb, M = self.Zb, self.M
        ws_l = ws[self.mem_l].reshape(-1)
        mass_l = s.mass[ws_l]
        contig_l = s.contig[ws_l]
        feas_hot = (
            hotpath.bitmap_fit_blocked(
                self._local_words(s), mass_l.reshape(Zb, M), contig_l.reshape(Zb, M)
            ).reshape(-1)
            != 0
        )
        alloc_bits_l, feas_l = bitmap.alloc_for_class(
            bits_l, mass_l, contig_l, policy=cfg.alloc_policy
        )
        feas_l = feas_l & feas_hot & has_w[self.mem_l].reshape(-1) & self.valid
        taken = alloc_bits_l & feas_l[:, None]
        alloc_words_l = bitmap.pack_bits(taken)
        bits_l = bits_l & ~taken
        alloc_words = self._to_flat(alloc_words_l.reshape(Zb, M, -1))  # (N, W)
        feas_n = self._to_flat(feas_l.reshape(Zb, M))  # (N,)
        return alloc_words, feas_n, bits_l

    def zone_aggregates(self, cfg: LaminarConfig, s: SimState):
        """Local zone rows through the zone_aggregate kernel, then the O(Z)
        aggregate-table gather (the modelled control-plane exchange)."""
        zS_l, zH_l = hotpath.zone_aggregate(
            s.rep_S[self.mem_l], s.rep_H[self.mem_l], self.msk_l
        )
        return self._gather(zS_l)[: self.Z], self._gather(zH_l)[: self.Z]


def traffic_model(
    cfg: LaminarConfig, num_zones: int, num_devices: int, max_zone: int | None = None
) -> Dict[str, float]:
    """Per-tick cross-shard bytes of the sharded tick, by category.

    The same arithmetic as the JAX package's ``traffic_model``: the bytes the
    design moves, not a measurement of this engine's exchange.
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


class ZoneShardedEngine(LaminarEngine):
    """:class:`LaminarEngine` whose tick runs the zone-sharded node plane.

    Same ``run`` / ``run_batch`` / ``simulate`` surface. Every rank of the
    process group constructs it and calls the same methods with the same
    arguments; ``device`` is this rank's device (default ``"cuda"``, the
    current CUDA device). ``run_batch`` runs the seeds one after another,
    as the JAX package's sharded engine does.
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

    def traffic(self, seed: int = 0) -> Dict[str, float]:
        """Traffic model for this engine's actual zone geometry."""
        Z, M = init_numpy(self.cfg, seed)["zmember"].shape
        return traffic_model(self.cfg, Z, self.num_devices, max_zone=M)
