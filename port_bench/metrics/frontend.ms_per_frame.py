"""The frontend's host ms per frame: the benchmark's spans around each
``extract_features[_sift]`` call, a synchronize on each side, over the
frames they took (the profiled sequence left out)."""


def read(trace):
    if not trace.get("frontend_frames"):
        return None
    return 1e3 * trace["frontend_s"] / trace["frontend_frames"]
