"""The SLAM driver's host ms per step: the benchmark's spans around each
sequence's ``run_slam`` call and the copy of its trajectory to the
host, over the steps they ran (the profiled sequence
left out)."""


def read(trace):
    if not trace.get("slam_steps"):
        return None
    return 1e3 * trace["slam_s"] / trace["slam_steps"]
