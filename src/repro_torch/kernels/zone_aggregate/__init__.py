from repro_torch.kernels.zone_aggregate.ops import zone_aggregate, zone_aggregate_members
from repro_torch.kernels.zone_aggregate.ref import zone_aggregate_members_ref, zone_aggregate_ref

__all__ = ["zone_aggregate", "zone_aggregate_members", "zone_aggregate_members_ref",
           "zone_aggregate_ref"]
