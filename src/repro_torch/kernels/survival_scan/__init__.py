from repro_torch.kernels.survival_scan.ops import survival_scan
from repro_torch.kernels.survival_scan.ref import survival_scan_ref

__all__ = ["survival_scan", "survival_scan_ref"]
