from repro_torch.kernels.node_view.ops import node_view
from repro_torch.kernels.node_view.ref import node_view_ref

__all__ = ["node_view", "node_view_ref"]
