from repro_torch.kernels.block_copy.ops import block_copy
from repro_torch.kernels.block_copy.ref import block_copy_ref

__all__ = ["block_copy", "block_copy_ref"]
