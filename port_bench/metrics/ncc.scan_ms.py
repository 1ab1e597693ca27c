"""Device ms per SLAM step of the NCC map matcher's candidate scan: the
13×13 grid's gathers, the NCC against the warped patch, the best
candidate and its xyz sample (``ekf/ncc_matching.py``), from the third
``slam_step.match`` probe of a step to the step's next probe, on the
device's clock, summed over the program trace's steps and divided by
them (port_bench/ncc_split.py)."""

from port_bench.ncc_split import part_ms


def read(trace):
    return part_ms(trace, "scan")
