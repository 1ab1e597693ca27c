"""The device's idle share over the program trace's sequences
(port_bench/program_trace.py): 1 − the union of every probe-bracketed
graph replay (frontend chunks, bootstraps, steps), mapped onto the host
clock, over the pass's wall time from a synchronize before the first
sequence to one after the last trajectory copy. Eager work between
replays counts as idle; no profiler stretches the wall time."""

from port_bench.program_trace import reading


def read(trace):
    return reading(trace, "device.idle_share.probed")
