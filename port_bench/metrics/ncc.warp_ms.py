"""Device ms per SLAM step of the NCC map matcher's warp: each landmark's
init patch predicted in the current view through its plane
(``frontend/patch_warp.py::predict_patches``), from the second
``slam_step.match`` probe of a step to the third, on the device's clock,
summed over the program trace's steps and divided by them
(port_bench/ncc_split.py)."""

from port_bench.ncc_split import part_ms


def read(trace):
    return part_ms(trace, "warp")
