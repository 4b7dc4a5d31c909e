"""kernels_roofline: the hand-written kernels' least time, summed over
their launches in the trace, as a share of their device time. A launch's
least time is its entry's inputs read once and outputs written once at the
card's peak bandwidth (``benchlib.roofline.entry_bytes``, from the cell's
shapes)."""

# each tick kernel's function name -> the entry whose work it does
ENTRIES = {
    "bitmap_fit_rounds_kernel": "bitmap_fit_rounds",
    "utility_topk_address_kernel": "utility_topk_address",
    "zone_aggregate_kernel": "zone_aggregate_members",
    "survival_cluster_kernel": "survival_scan",
}


def read(trace):
    spent = trace.device_s(kinds=("kernel",), names=tuple(ENTRIES))
    if spent <= 0:
        return None
    least = sum(trace.count(names=(k,)) * trace.entry_bytes[e] for k, e in ENTRIES.items())
    return least / trace.peak_bytes_per_s / spent * 100.0
