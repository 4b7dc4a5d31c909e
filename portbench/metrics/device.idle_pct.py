"""device.idle_pct: the share of the traced stretch's wall time in which no
kernel, copy or memset ran on the device."""


def read(trace):
    busy = trace.busy_s()
    if busy is None:
        return None
    return (1.0 - busy / trace.wall_s) * 100.0
