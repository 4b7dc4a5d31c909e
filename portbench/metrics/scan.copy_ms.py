"""scan.copy_ms: device memcpy and memset ms a replay (the compiled run's
copies: the state copied back into its buffers, the series ring)."""


def read(trace):
    if not trace.device_ops:
        return None
    return trace.device_s(kinds=("memcpy", "memset")) / trace.replays * 1e3
