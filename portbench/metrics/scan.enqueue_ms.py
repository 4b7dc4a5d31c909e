"""scan.enqueue_ms: host ms a replay to enqueue a segment: the wall time of
one ``simulate`` call of the compiled run (it returns without waiting for
the device) over its replays, taken on the host clock with the profiler
off (its tracing slows every launch), after a wait for the device, so no
launch waits for room in the device's queue."""


def read(trace):
    if not trace.device_ops:
        return None
    return trace.enqueue_s / trace.replays * 1e3
