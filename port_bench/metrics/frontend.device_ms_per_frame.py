"""Device ms per frame of the frontend's chunk program: each chunk
replay's begin probe to its end probe, on the device's clock, summed
over the program trace's frontend calls and divided by their frames
(port_bench/program_trace.py)."""

from port_bench.program_trace import reading


def read(trace):
    return reading(trace, "frontend.device_ms_per_frame")
