"""Hand-written Hopper kernels for the control-plane hot spots.

Each package ships ``ref.py`` (the plain PyTorch version, a port of the JAX
package's ``ref.py``), ``plan.py`` (the launch plan: grid, block, shared
memory and outputs for given shapes, and ``KERNELS``, the source's
``__global__`` functions) and ``ops.py`` (the wrappers: a CUDA tensor
launches the kernel built from ``csrc/<package>.cu`` under its plan, a CPU
tensor takes the plain version). Every wrapper counts its kernel launches in
``<wrapper>.launches``.

  * ``bitmap_fit``    — per-node demand feasibility against bitmap words
    (and ``bitmap_fit_blocked``, the same kernel over zone-blocked rows;
    ``bitmap_fit_rounds``, every arbitration round of the flat tick in one
    cluster launch; ``bitmap_fit_rounds_blocked``, the same rounds on one
    rank's zone block, the zone-sharded tick's)
  * ``utility_topk``  — fused DA utility scoring + candidate argmax (and
    ``utility_topk_address``, the whole DA addressing step in one launch)
  * ``zone_aggregate``— per-zone mean slack / total heat (and
    ``zone_aggregate_members``, the whole TEG refresh in one launch)
  * ``survival_scan`` — fused Airlock survival decision
  * ``node_view``     — each node's free atoms and longest free run from its
    packed words: the tick's true node view (replaces no TPU kernel; the
    JAX package builds the view in plain jnp)
  * ``block_copy``    — a float32 block copy under any plan: the port of the
    static analyzer's known-bad fixture kernels, on no main path

The five entries of the flat tick (:data:`LOCKSTEP`) take an optional
leading seed axis: their plan builder reads it from the shapes
(``LaunchPlan.seeds``), and the wrapper then launches the same kernel once
for all seeds, a seed axis in its grid (on the CPU, the plain version seed
by seed). Each is also a custom op ``repro_torch::<entry>`` whose batching
rule under ``torch.func.vmap`` calls the wrapper once with the seed axis
(``kernels.batching``): the lockstep engine's tick.

:data:`ENTRIES` is the one list of the entries; every other list of the
port's kernels is derived from it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.kernels.bitmap_fit import ops as bitmap_fit
from repro_torch.kernels.bitmap_fit import plan as _bitmap_plan
from repro_torch.kernels.block_copy import ops as _copy_ops
from repro_torch.kernels.block_copy import plan as _copy_plan
from repro_torch.kernels.node_view import ops as node_view
from repro_torch.kernels.node_view import plan as _view_plan
from repro_torch.kernels.survival_scan import ops as survival_scan
from repro_torch.kernels.survival_scan import plan as _surv_plan
from repro_torch.kernels.utility_topk import ops as utility_topk
from repro_torch.kernels.utility_topk import plan as _topk_plan
from repro_torch.kernels.zone_aggregate import ops as zone_aggregate
from repro_torch.kernels.zone_aggregate import plan as _agg_plan


@dataclasses.dataclass(frozen=True)
class Entry:
    """One hand-written kernel entry."""

    wrapper: Callable  # ops.py: the kernel for CUDA tensors, the plain version for CPU ones
    plan: Callable  # the launch plan for the wrapper's arguments (plan.py)
    launch: Callable  # launch(plan, outs, *args, **kw): what the wrapper calls; counts nothing
    kernel: str  # the __global__ it launches, as the profiler names it (template arguments apart)
    tick: bool  # a tick calls it (the flat, lockstep or zone-sharded tick)
    op: Optional[Any] = None  # its custom op, batched under vmap: it takes a leading seed axis

    @property
    def source(self) -> str:
        """``csrc/<source>.cu``, named as its package."""
        return self.plan.__module__.split(".")[-2]


ENTRIES: Dict[str, Entry] = {
    "bitmap_fit": Entry(bitmap_fit.bitmap_fit, _bitmap_plan.for_call, bitmap_fit.launch,
                        "bitmap_fit_kernel", tick=False),
    "bitmap_fit_blocked": Entry(bitmap_fit.bitmap_fit_blocked, _bitmap_plan.for_blocked_call,
                                bitmap_fit.launch, "bitmap_fit_kernel", tick=False),
    "bitmap_fit_rounds": Entry(bitmap_fit.bitmap_fit_rounds, _bitmap_plan.for_rounds_call,
                               bitmap_fit.launch_rounds, "bitmap_fit_rounds_kernel", tick=True,
                               op=bitmap_fit.bitmap_fit_rounds_op),
    "bitmap_fit_rounds_blocked": Entry(
        bitmap_fit.bitmap_fit_rounds_blocked, _bitmap_plan.for_rounds_blocked_call,
        bitmap_fit.launch_rounds_blocked, "bitmap_fit_rounds_blocked_kernel", tick=True),
    "utility_topk": Entry(utility_topk.utility_topk, _topk_plan.for_call, utility_topk.launch,
                          "utility_topk_kernel", tick=False),
    "utility_topk_address": Entry(
        utility_topk.utility_topk_address, _topk_plan.for_address_call,
        utility_topk.launch_address, "utility_topk_address_kernel", tick=True,
        op=utility_topk.utility_topk_address_op),
    "zone_aggregate": Entry(zone_aggregate.zone_aggregate, _agg_plan.for_call,
                            zone_aggregate.launch, "zone_aggregate_kernel", tick=False),
    "zone_aggregate_members": Entry(
        zone_aggregate.zone_aggregate_members, _agg_plan.for_members_call,
        zone_aggregate.launch_members, "zone_aggregate_kernel", tick=True,
        op=zone_aggregate.zone_aggregate_members_op),
    "survival_scan": Entry(survival_scan.survival_scan, _surv_plan.for_call,
                           survival_scan.launch, "survival_cluster_kernel", tick=True,
                           op=survival_scan.survival_scan_op),
    "node_view": Entry(node_view.node_view, _view_plan.for_call, node_view.launch,
                       "node_view_kernel", tick=True, op=node_view.node_view_op),
    "block_copy": Entry(_copy_ops.block_copy, _copy_plan.for_call, _copy_ops.launch,
                        "block_copy_kernel", tick=False),
}
# the flat tick's entries, which take a leading seed axis (the lockstep tick's)
LOCKSTEP = tuple(name for name, e in ENTRIES.items() if e.op is not None)
# the sources to build, and the hand-written kernels as the profiler names them
SOURCES = tuple(dict.fromkeys(e.source for e in ENTRIES.values()))
HAND_WRITTEN = tuple(dict.fromkeys(e.kernel for e in ENTRIES.values()))


def entry_of(kernel_name: str) -> Optional[str]:
    """The entry that launched a kernel node named ``kernel_name`` (a
    profiler's or a graph's name, mangled or not): the entry a tick calls
    for that kernel; for a hand-written kernel that no tick launches, the
    kernel's own name; None for any other kernel."""
    kernel = next((k for k in HAND_WRITTEN if k in kernel_name), None)
    if kernel is None:
        return None
    return next((n for n, e in ENTRIES.items() if e.tick and e.kernel == kernel), kernel)


__all__ = ["ENTRIES", "HAND_WRITTEN", "LOCKSTEP", "SOURCES", "Entry", "bitmap_fit", "entry_of",
           "node_view", "survival_scan", "utility_topk", "zone_aggregate"]
