"""Device kernels the profiler saw in the traced window, per step."""


def read(r):
    steps = r.counters.get("steps")
    if r.trace is None or not steps or r.trace.kernels == 0:
        return None
    return r.trace.kernels / steps
