"""Host-issued launches per SLAM step (kernel and graph launches, copies
and memsets, as the profiler counts them) over one sequence's driver
call, bootstrap and per-call copies included."""


def read(trace):
    w = trace.get("driver")
    if w is None or w.launches <= 0:
        return None
    return w.launches / trace["driver_steps"]
