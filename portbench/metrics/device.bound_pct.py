"""device.bound_pct: the tick's least time as a share of its device time a
replay. The least time is the state and the tick's draws read once and the
new state and series row written once at the card's peak bandwidth
(``benchlib.roofline.tick_bytes``); the device time is the seconds in which
some operation ran."""


def read(trace):
    busy = trace.busy_s()
    if not busy:
        return None
    least = trace.tick_bytes / trace.peak_bytes_per_s
    return least / (busy / trace.replays) * 100.0
