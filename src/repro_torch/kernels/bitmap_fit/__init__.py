from repro_torch.kernels.bitmap_fit.ops import bitmap_fit
from repro_torch.kernels.bitmap_fit.ref import bitmap_fit_ref

__all__ = ["bitmap_fit", "bitmap_fit_ref"]
