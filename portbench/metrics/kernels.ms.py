"""kernels.ms: device ms a replay of the port's hand-written kernels, by the
function names below."""

HAND_WRITTEN = ("bitmap_fit_rounds_kernel", "bitmap_fit_rounds_blocked_kernel",
                "bitmap_fit_kernel", "utility_topk_address_kernel", "utility_topk_kernel",
                "zone_aggregate_kernel", "survival_cluster_kernel", "block_copy_kernel")


def read(trace):
    if not trace.count(names=HAND_WRITTEN):
        return None
    return trace.device_s(kinds=("kernel",), names=HAND_WRITTEN) / trace.replays * 1e3
