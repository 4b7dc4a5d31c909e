"""Hand-written Hopper kernels for the control-plane hot spots.

Each package ships ``ref.py`` (the plain PyTorch version, a port of the JAX
package's ``ref.py``), ``plan.py`` (the launch plan: grid, block, shared
memory and outputs for given shapes) and ``ops.py`` (the wrapper: a CUDA
tensor launches the kernel built from ``csrc/<name>.cu`` under its plan, a
CPU tensor takes the plain version). Every wrapper counts its kernel
launches in ``<wrapper>.launches``.

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

The five entries of the flat tick (``bitmap_fit_rounds``,
``utility_topk_address``, ``zone_aggregate_members``, ``survival_scan``,
``node_view``) each have a ``<entry>_batched`` twin over a leading seed
axis, one launch for all seeds, and a custom op ``repro_torch::<entry>`` that
``torch.func.vmap`` maps onto the twin (``kernels.batching``): the
lockstep engine's tick. The twin launches the entry's own kernel with a
seed axis in its grid, under the entry's own plan builder and launcher
(an unbatched call is one seed); it only counts its launches apart.

``WRAPPERS``, ``PLANS`` and ``LAUNCHERS`` map each hot-path entry to its
wrapper, its plan for the wrapper's arguments, and the launch function the
wrapper calls (``launch(plan, outs, *args, **kw)``).
"""

from repro_torch.kernels.bitmap_fit import ops as bitmap_fit
from repro_torch.kernels.bitmap_fit import plan as _bitmap_plan
from repro_torch.kernels.node_view import ops as node_view
from repro_torch.kernels.node_view import plan as _view_plan
from repro_torch.kernels.survival_scan import ops as survival_scan
from repro_torch.kernels.survival_scan import plan as _surv_plan
from repro_torch.kernels.utility_topk import ops as utility_topk
from repro_torch.kernels.utility_topk import plan as _topk_plan
from repro_torch.kernels.zone_aggregate import ops as zone_aggregate
from repro_torch.kernels.zone_aggregate import plan as _agg_plan

WRAPPERS = {
    "bitmap_fit": bitmap_fit.bitmap_fit,
    "bitmap_fit_blocked": bitmap_fit.bitmap_fit_blocked,
    "bitmap_fit_rounds": bitmap_fit.bitmap_fit_rounds,
    "bitmap_fit_rounds_blocked": bitmap_fit.bitmap_fit_rounds_blocked,
    "utility_topk": utility_topk.utility_topk,
    "utility_topk_address": utility_topk.utility_topk_address,
    "zone_aggregate": zone_aggregate.zone_aggregate,
    "zone_aggregate_members": zone_aggregate.zone_aggregate_members,
    "survival_scan": survival_scan.survival_scan,
    "node_view": node_view.node_view,
    "bitmap_fit_rounds_batched": bitmap_fit.bitmap_fit_rounds_batched,
    "utility_topk_address_batched": utility_topk.utility_topk_address_batched,
    "zone_aggregate_members_batched": zone_aggregate.zone_aggregate_members_batched,
    "survival_scan_batched": survival_scan.survival_scan_batched,
    "node_view_batched": node_view.node_view_batched,
}
PLANS = {
    "bitmap_fit": _bitmap_plan.for_call,
    "bitmap_fit_blocked": _bitmap_plan.for_blocked_call,
    "bitmap_fit_rounds": _bitmap_plan.for_rounds_call,
    "bitmap_fit_rounds_blocked": _bitmap_plan.for_rounds_blocked_call,
    "utility_topk": _topk_plan.for_call,
    "utility_topk_address": _topk_plan.for_address_call,
    "zone_aggregate": _agg_plan.for_call,
    "zone_aggregate_members": _agg_plan.for_members_call,
    "survival_scan": _surv_plan.for_call,
    "node_view": _view_plan.for_call,
    "bitmap_fit_rounds_batched": _bitmap_plan.for_rounds_call,
    "utility_topk_address_batched": _topk_plan.for_address_call,
    "zone_aggregate_members_batched": _agg_plan.for_members_call,
    "survival_scan_batched": _surv_plan.for_call,
    "node_view_batched": _view_plan.for_call,
}
LAUNCHERS = {
    "bitmap_fit": bitmap_fit.launch,
    "bitmap_fit_blocked": bitmap_fit.launch,
    "bitmap_fit_rounds": bitmap_fit.launch_rounds,
    "bitmap_fit_rounds_blocked": bitmap_fit.launch_rounds_blocked,
    "utility_topk": utility_topk.launch,
    "utility_topk_address": utility_topk.launch_address,
    "zone_aggregate": zone_aggregate.launch,
    "zone_aggregate_members": zone_aggregate.launch_members,
    "survival_scan": survival_scan.launch,
    "node_view": node_view.launch,
    "bitmap_fit_rounds_batched": bitmap_fit.launch_rounds,
    "utility_topk_address_batched": utility_topk.launch_address,
    "zone_aggregate_members_batched": zone_aggregate.launch_members,
    "survival_scan_batched": survival_scan.launch,
    "node_view_batched": node_view.launch,
}
# each flat-tick entry's batched twin (its custom op's batching rule)
BATCHED = {name[: -len("_batched")]: name for name in WRAPPERS if name.endswith("_batched")}

__all__ = ["BATCHED", "LAUNCHERS", "PLANS", "WRAPPERS", "bitmap_fit", "node_view", "survival_scan",
           "utility_topk", "zone_aggregate"]
