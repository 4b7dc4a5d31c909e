"""LC301/LC302/LC303 fixture: mis-covering launch plans of the block copy.

The port of ``tests/fixtures/analysis/bad_blockspec_tail.py``: the same
float32 copy of a (1024,) probe table in blocks of 128, run by the port's
``block_copy`` kernel, under the same three faults, which live in the plans
as they lived in the grid / BlockSpecs:

  * ``tail_dropping_grid`` — the historical survival-scan bug shape, a grid
    one block short (7 blocks): the tail block is never written;
  * ``index_map_overshoot`` — 8 blocks whose input map is ``i + 1``: the
    last block reads one block past the end (and block 0 is never read);
  * ``vmem_over_budget`` — one whole-array block, 4 KiB of staging in
    shared memory, against a deliberately tiny 1024-byte budget.
"""

from repro_torch.analysis.kernel_contract import audit_launch_plan
from repro_torch.kernels.block_copy.plan import plan

BLOCK = 128
PADDED = 1024  # probe table padded to a block multiple
HOG_BUDGET = 1024

# name -> (plan, shared-memory budget in bytes or None for the H100's)
PLANS = {
    # the bug: `PADDED // BLOCK - 1` drops the tail block entirely
    "tail_dropping_grid": (plan(PADDED, BLOCK, PADDED // BLOCK - 1), None),
    # off-by-one input map: the last block addresses one block past the end
    "index_map_overshoot": (plan(PADDED, BLOCK, PADDED // BLOCK, in_block_offset=1), None),
    # whole-array blocks against a deliberately tiny budget
    "vmem_over_budget": (plan(PADDED, PADDED, 1), HOG_BUDGET),
}


def tail_dropping_grid():
    p, budget = PLANS["tail_dropping_grid"]
    return audit_launch_plan(p, name="survival_scan[tail-dropped]", budget_bytes=budget)


def index_map_overshoot():
    p, budget = PLANS["index_map_overshoot"]
    return audit_launch_plan(p, name="survival_scan[overshoot]", budget_bytes=budget)


def vmem_over_budget():
    p, budget = PLANS["vmem_over_budget"]
    return audit_launch_plan(p, name="survival_scan[hog]", budget_bytes=budget)


LAMINAR_CHECK_TARGETS = [tail_dropping_grid, index_map_overshoot, vmem_over_budget]
