from repro_torch.kernels.utility_topk.ops import utility_topk, utility_topk_address
from repro_torch.kernels.utility_topk.ref import utility_topk_address_ref, utility_topk_ref

__all__ = ["utility_topk", "utility_topk_address", "utility_topk_address_ref", "utility_topk_ref"]
