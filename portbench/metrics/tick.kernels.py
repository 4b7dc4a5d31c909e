"""tick.kernels: device kernels a replay."""


def read(trace):
    n = trace.count()
    return n / trace.replays if n else None
