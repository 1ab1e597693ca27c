"""K1's share of its roofline over one sequence's driver call: the
bound of a launch (port_bench/roofline.py, from the launch shapes one
step makes, averaged over them) times the launches the profiler saw,
over the profiler's time of K1's kernels. At a million events the
profiler can miss some records of a replayed graph's kernels; the
launches it saw stand for the rest. Nothing where it saw none."""

from port_bench.roofline import KERNELS
from port_bench.tracing import kernel_time


def read(trace):
    w = trace.get("driver")
    if w is None:
        return None
    bounds = trace["bounds"]["k1"]
    launches, seconds = kernel_time(w, KERNELS["k1"])
    if not launches or seconds <= 0:
        return None
    return 100.0 * sum(bounds) / len(bounds) * launches / seconds
