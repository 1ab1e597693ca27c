"""Profiler windows on the card (``torch.profiler``, CPU and CUDA
activity): what the host issued, what ran on the device and when the
device sat idle. The launch set and the device-op filter are copies of
``pre3_tpu_torch/utils/profile_slice.py``'s.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

# What the host issues to the card: kernel launches, graph launches (a
# replayed step program is one) and copies and memsets.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync")


class Window(NamedTuple):
    launches: int  # host-issued launches, copies and memsets
    busy_s: float  # device time of kernels, copies and fills
    wall_s: float  # from a synchronize before the work to one after it
    ops: list  # [(name, count, device seconds)] of every device op
    gaps: list  # [(what the host was doing, seconds)], longest first


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _annotation(name: str) -> bool:
    """The benchmark's own ranges and the profiler's step spans, which the
    trace also lists on the device's timeline."""
    return name.startswith(("bench.", "ProfilerStep"))


def window_of(prof, wall: float, label: str | None = None) -> Window:
    """A finished profiler's ``Window``, read from its raw events (the
    per-event Python objects of ``key_averages`` would cost minutes at a
    million kernels); its idle gaps are those inside the ``label`` range
    (or between the first and the last event)."""
    ops: dict = {}
    busy, host = [], []
    launches = 0
    t0, t1 = None, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if name in LAUNCHES:
            launches += 1
        if name == label:
            t0, t1 = start, end
        if e.device_type() == DeviceType.CUDA:
            if _annotation(name):
                continue
            c, sec = ops.get(name, (0, 0.0))
            ops[name] = (c + 1, sec + (end - start) / 1e9)
            busy.append((start, end))
        else:
            host.append((start, end, name))
    if t0 is None:
        edges = [b for b in busy] + [(a, b) for a, b, _ in host]
        t0, t1 = min(a for a, _ in edges), max(b for _, b in edges)
    return Window(launches, sum(sec for _, sec in ops.values()), wall,
                  [(k, c, sec) for k, (c, sec) in ops.items()],
                  _gaps(busy, host, t0, t1))


def _gaps(busy: list, host: list, t0_ns: int, t1_ns: int,
          top: int = 10) -> list:
    """The longest idle stretches of the device inside [t0, t1], each
    named by the innermost host event running at its middle."""
    busy.sort()
    gaps, edge = [], t0_ns
    for start, end in busy:
        if start > edge:
            gaps.append((edge, min(start, t1_ns)))
        edge = max(edge, end)
    if t1_ns > edge:
        gaps.append((edge, t1_ns))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        inside = [h for h in host if h[0] <= mid <= h[1]
                  and not _annotation(h[2])]
        name = min(inside, key=lambda h: h[1] - h[0])[2] if inside \
            else "host (no traced call)"
        out.append((name, (b - a) / 1e9))
    return out


def profiled(fn, label: str = "bench.window"):
    """(fn(), Window) of one run of ``fn`` in one profiler window. The
    window's wall time runs from a synchronize before fn to one after
    it, so busy / wall is the device's busy share of that window."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        mark0 = time.perf_counter()
        with record_function(label):
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - mark0
    return out, window_of(prof, wall, label)


def merge(windows: list[Window]) -> Window:
    """Several windows read as one: sums, ops merged by name, gaps the
    longest of all."""
    ops: dict = {}
    for w in windows:
        for name, count, s in w.ops:
            c0, s0 = ops.get(name, (0, 0.0))
            ops[name] = (c0 + count, s0 + s)
    gaps = sorted((g for w in windows for g in w.gaps), key=lambda g: -g[1])
    return Window(sum(w.launches for w in windows),
                  sum(w.busy_s for w in windows),
                  sum(w.wall_s for w in windows),
                  [(k, c, s) for k, (c, s) in ops.items()], gaps[:10])


def kernel_time(window: Window, substring: str) -> tuple[int, float]:
    """(launches, device seconds) of the ops whose name holds
    ``substring``."""
    hits = [(c, s) for name, c, s in window.ops if substring in name]
    return sum(c for c, _ in hits), sum(s for _, s in hits)


def breakdown(window: Window) -> dict:
    """The ``breakdown`` of a traced run's result line."""
    top = sorted(window.ops, key=lambda o: -o[2])[:10]
    return {"device_ops": [[name, s] for name, _, s in top],
            "idle_gaps": [[name, s] for name, s in window.gaps[:10]]}
