"""Scale-out: the zone-sharded engine on ``torch.distributed``.

  * :mod:`repro_torch.parallel.engine_mesh` — ``ZoneShardedEngine``,
    ``MeshPlane``, ``traffic_model``, ``zone_group``
  * :mod:`repro_torch.parallel.local` — ``run_local``: D ranks as D local
    processes (gloo on the CPU, NCCL on CUDA); also a command line;
    ``spawn_ranks`` for any function
  * :mod:`repro_torch.parallel.sharding` — the model's sharding rules
    (parameter, batch and cache specs) and their DTensor placements
"""

from repro_torch.parallel.engine_mesh import (
    MeshPlane,
    ZoneShardedEngine,
    traffic_model,
    zone_group,
)

__all__ = ["MeshPlane", "ZoneShardedEngine", "traffic_model", "zone_group"]
