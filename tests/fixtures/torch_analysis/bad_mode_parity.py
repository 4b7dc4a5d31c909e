"""LC204/LC304 fixture: CUDA-route / CPU-route and plan / ``_ref`` mismatches."""

import torch

from repro_torch.analysis.kernel_contract import compare_output_avals
from repro_torch.analysis.trace_audit import compare_branch_avals
from repro_torch.kernels.launch_plan import Output


def routes_disagree_on_dtype():
    # a device-dispatched op whose CUDA side narrows its output
    return compare_branch_avals(
        "toy_dispatch",
        lambda x: x.to(torch.float32),
        lambda x: x.to(torch.bfloat16),
        (torch.zeros(8),),
    )


def plan_ref_outputs_disagree():
    plan_outs = (Output("y", (8,), torch.int32),)
    return compare_output_avals("toy_kernel", plan_outs, torch.zeros(8, dtype=torch.float32))


LAMINAR_CHECK_TARGETS = [routes_disagree_on_dtype, plan_ref_outputs_disagree]
