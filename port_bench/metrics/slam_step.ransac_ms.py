"""Device ms per SLAM step of slam_step's stage ``ransac`` (1-point RANSAC):
from its probe to the next one, on the device's clock, summed over the
program trace's steps (port_bench/program_trace.py) and divided by
them."""

from port_bench.program_trace import reading


def read(trace):
    return reading(trace, "slam_step.ransac_ms")
