"""Device ms per SLAM step of the step program's replay: its
``scan_steps.begin`` probe to its ``.end`` probe, on the device's clock,
averaged over the program trace's steps (port_bench/program_trace.py):
the step's device time with no profiler active."""

from port_bench.program_trace import reading


def read(trace):
    return reading(trace, "slam.replay_ms")
