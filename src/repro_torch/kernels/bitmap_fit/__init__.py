from repro_torch.kernels.bitmap_fit.ops import (
    bitmap_fit,
    bitmap_fit_blocked,
    bitmap_fit_rounds,
    bitmap_fit_rounds_blocked,
)
from repro_torch.kernels.bitmap_fit.ref import (
    bitmap_fit_blocked_ref,
    bitmap_fit_ref,
    bitmap_fit_rounds_blocked_ref,
    bitmap_fit_rounds_ref,
)

__all__ = ["bitmap_fit", "bitmap_fit_blocked", "bitmap_fit_blocked_ref", "bitmap_fit_ref",
           "bitmap_fit_rounds", "bitmap_fit_rounds_blocked", "bitmap_fit_rounds_blocked_ref",
           "bitmap_fit_rounds_ref"]
