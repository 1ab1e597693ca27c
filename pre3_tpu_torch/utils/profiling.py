"""Tracing / profiling hooks.

Port of ``pre3_tpu/utils/profiling.py``: per-stage wall-clock accounting
(``StageTimer``, as the reference has it) and a device-level trace of a
region. The reference's ``xla_trace`` wraps ``jax.profiler.trace``; here
``device_trace`` wraps ``torch.profiler`` (CPU and, where there is a card,
CUDA activity) and writes a Chrome trace viewable in chrome://tracing or
Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall-clock per named stage; thread-safe enough for the
    online pipeline's producer thread (GIL-serialized appends)."""

    def __init__(self) -> None:
        self._acc: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._acc[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        """{stage: {count, total_s, mean_ms, max_ms}}"""
        out = {}
        for name, xs in self._acc.items():
            n = len(xs)
            out[name] = {
                "count": n,
                "total_s": sum(xs),
                "mean_ms": 1e3 * sum(xs) / max(n, 1),
                "max_ms": 1e3 * max(xs) if xs else 0.0,
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>7}{'mean ms':>10}{'max ms':>10}"
                 f"{'total s':>10}"]
        for name, s in sorted(
            self.summary().items(), key=lambda kv: -kv[1]["total_s"]
        ):
            lines.append(
                f"{name:<24}{s['count']:>7}{s['mean_ms']:>10.2f}"
                f"{s['max_ms']:>10.2f}{s['total_s']:>10.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Wrap a region in a ``torch.profiler`` trace (no-op when log_dir is
    None): CPU activity always, CUDA activity where a card is present.
    Yields the profiler (``key_averages()`` for sums by kernel, or None)
    and writes ``<log_dir>/trace.json`` at exit."""
    if log_dir is None:
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
