"""The NCC map matcher's two parts, read from the program trace's probes
(``port_bench/program_trace.py``): the warp of the init patches and the
candidate scan.

On the ``ncc_warp`` path ``slam_step``'s match stage carries three probes
of its own tag, ``slam_step.match``: the stage's start (the measurement
prediction), then one before ``predict_patches`` (the warp), then one
before the candidate grid (the scan: the gathers, the NCC, the best
candidate and its xyz sample), which runs to the step's next probe. The
stage readings of ``program_trace`` sum all three as ``match``. Probes
between ``bench.pass.begin`` and ``.end`` are assigned to steps by the
step program's ``scan_steps.begin``/``.end`` pairs; each part's device
time is summed over the pass's steps and divided by them. A step with
fewer than three match probes (the descriptor matcher, or a port
without these probes) gives no reading.
"""

from __future__ import annotations

from port_bench.program_trace import reading

PARTS = ("warp", "scan")


def split(probes: list) -> dict | None:
    """{part: device ms per step} from an export's probes ([tag, device
    ns, host ns] in slot order), or None."""
    tags = [p[0] for p in probes]
    if "bench.pass.begin" not in tags or "bench.pass.end" not in tags:
        return None
    probes = probes[tags.index("bench.pass.begin") + 1:
                    tags.index("bench.pass.end")]
    total = dict.fromkeys(PARTS, 0)
    steps, step = 0, None
    for i, p in enumerate(probes):
        if p[0] == "scan_steps.begin":
            step = []
        elif p[0] == "scan_steps.end" and step is not None:
            if len(step) < 3:
                return None
            warp, scan = step[1], step[2]
            total["warp"] += probes[scan][1] - probes[warp][1]
            total["scan"] += probes[scan + 1][1] - probes[scan][1]
            steps, step = steps + 1, None
        elif p[0] == "slam_step.match" and step is not None:
            step.append(i)
    if not steps:
        return None
    return {part: ns / (1e6 * steps) for part, ns in total.items()}


def part_ms(trace: dict, part: str):
    """The device ms per step of ``part`` (``warp`` or ``scan``) over
    the pass, the pass run first if it has not run; None where the trace
    has no such reading."""
    if "program" not in trace:
        reading(trace, "slam_step.match_ms")
    try:
        got = split(trace["program"]["probes"])
    except (KeyError, TypeError, IndexError):
        return None
    return None if got is None else got[part]
