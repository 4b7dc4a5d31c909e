"""tick.plain_ms: device ms a replay of the kernels that are not the port's
hand-written ones (PyTorch's own: the tick's plain operations)."""

HAND_WRITTEN = ("bitmap_fit_rounds_kernel", "bitmap_fit_rounds_blocked_kernel",
                "bitmap_fit_kernel", "utility_topk_address_kernel", "utility_topk_kernel",
                "zone_aggregate_kernel", "survival_cluster_kernel", "block_copy_kernel")


def read(trace):
    if not trace.count():
        return None
    return trace.device_s(kinds=("kernel",), exclude=HAND_WRITTEN) / trace.replays * 1e3
