"""Device ms per SLAM step: the profiler's device time (kernels, copies,
fills) over one sequence's driver call, over its steps."""


def read(trace):
    w = trace.get("driver")
    if w is None or w.busy_s <= 0:
        return None
    return 1e3 * w.busy_s / trace["driver_steps"]
