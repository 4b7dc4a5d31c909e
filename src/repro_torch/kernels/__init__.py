"""Hand-written Hopper kernels for the four control-plane hot spots.

Each package ships ``ref.py`` (the plain PyTorch version, a port of the JAX
package's ``ref.py``) and ``ops.py`` (the wrapper: a CUDA tensor launches the
kernel built from ``csrc/<name>.cu``, a CPU tensor takes the plain version).
Every wrapper counts its kernel launches in ``<wrapper>.launches``.

  * ``bitmap_fit``    — per-node demand feasibility against bitmap words
  * ``utility_topk``  — fused DA utility scoring + candidate argmax
  * ``zone_aggregate``— per-zone mean slack / total heat
  * ``survival_scan`` — fused Airlock survival decision
"""

from repro_torch.kernels.bitmap_fit import ops as bitmap_fit
from repro_torch.kernels.survival_scan import ops as survival_scan
from repro_torch.kernels.utility_topk import ops as utility_topk
from repro_torch.kernels.zone_aggregate import ops as zone_aggregate

WRAPPERS = {
    "bitmap_fit": bitmap_fit.bitmap_fit,
    "utility_topk": utility_topk.utility_topk,
    "zone_aggregate": zone_aggregate.zone_aggregate,
    "survival_scan": survival_scan.survival_scan,
}

__all__ = ["WRAPPERS", "bitmap_fit", "survival_scan", "utility_topk", "zone_aggregate"]
