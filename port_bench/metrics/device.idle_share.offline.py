"""The device's idle share over one sequence's profiled windows (its
frontend call and its driver call): 1 − device busy ÷ their wall time.
The profiler stretches the wall time, so this overstates idle."""


def read(trace):
    w = trace.get("window")
    if w is None or "driver" not in trace or w.wall_s <= 0:
        return None
    return 1.0 - w.busy_s / w.wall_s
