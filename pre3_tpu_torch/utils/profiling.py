"""The port's tracer, and per-stage wall-clock accounting.

The tracer is off unless a caller turns it on (``tracing()``, a context
manager; no environment variable does). Off, every call site below costs
one test of a module-global flag: nothing is recorded, no
``record_function`` range is entered, no probe kernel is built or loaded
and no buffer is made. On, it keeps, in memory until ``export()``:

* spans (``span(name)``): name, id, the parent span's id, a request id
  and start and end on the host clock (``clock_ns``, the clock of
  ``torch.profiler``'s host events). A span opened with ``request=True``
  (``run_slam``, a frontend call) starts a new request id, which the
  spans inside it share. While a profiler is active each span also
  enters a ``record_function`` range of its name, so a profiled window
  names its idle stretches by the program's spans;
* counters (``count(name, n)``), by name;
* probes (``probe(tag, device)``): a timestamp on the device. On a CUDA
  device a one-thread kernel (``csrc/probe.cu``) launched on the current
  stream writes (tag, ``%globaltimer``) into the next slot of a device
  ring, so a CUDA graph capture records it as a node and every replay
  writes fresh slots with no synchronize. Anywhere else a probe records
  the host clock. A probe takes no tensor, so it is safe under
  ``torch.func.vmap`` (it fires once per batched call). Inside
  ``launch_count.uncounted()`` (a step program's warm-up before its
  capture) the kernel is launched with a null ring and records nothing,
  as K1 and K2 count nothing there.

The ring is made when tracing turns on, outside any capture (on another
card, at its first probe, a program's warm-up), with room for
``RING_CAPACITY`` probes; probes past it are dropped and counted. A
captured probe node holds the ring's address, so when tracing turns off
every step program's traced graphs are dropped with the ring
(``graphs.drop_traced``) before it is freed. Device times are mapped
onto the host clock by ``CALIBRATION_PROBES`` eager probes, each
bracketed by host clock reads and synchronizes, when tracing turns on
and again when it turns off (a second card's probes are mapped by the
first card's calibration).

``export()`` gives the spans, each span name's count, total and self
time (its time less that of its child spans), the counters and the
probes with their host times; ``write_chrome_trace`` writes an export
as a Chrome trace (chrome://tracing, Perfetto).

``StageTimer`` accumulates host wall-clock per named stage, as the JAX
package's does (``OnlineSlam`` keeps one); while tracing is on each of
its stages is also a span of the same name.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import threading
import time
from collections import defaultdict

import torch

from pre3_tpu_torch.utils import launch_count
from pre3_tpu_torch.utils.cuda_build import load_library

# The host clock of spans and of probes off the card: the clock of
# torch.profiler's host events (CLOCK_REALTIME on Linux; held by
# tests/test_torch_tracing.py).
clock_ns = time.time_ns

# Eager probes that map device times onto the host clock, when tracing
# turns on and again when it turns off.
CALIBRATION_PROBES = 16
# Probes a device ring holds: a traced pass of two 256-frame corridors
# fires ~4600.
RING_CAPACITY = 1 << 16
_CALIBRATE = "profiling.calibrate"

_ON = False
_REC: _Recorder | None = None
_LAST: dict | None = None  # the export of the last traced region
_NULL = contextlib.nullcontext()


def on() -> bool:
    """Whether tracing is on."""
    return _ON


def span(name: str, request: bool = False):
    """A context manager recording a span ``name`` while tracing is on;
    ``request``: the span starts a new request id (see the module
    docstring)."""
    if not _ON:
        return _NULL
    return _Span(_REC, name, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _ON:
        _REC.counters[name] += n


def probe(tag: str, device=None) -> None:
    """A timestamp ``tag`` while tracing is on: on the device's current
    stream for a CUDA ``device``, else on the host clock."""
    if _ON:
        _REC.probe(tag, device)


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block (see the module docstring); read it
    with ``export()``, inside or after the block."""
    global _ON, _REC, _LAST
    if _ON:
        raise RuntimeError("tracing is already on")
    rec = _Recorder()
    if torch.cuda.is_available():
        rec.calibrate(torch.device("cuda", torch.cuda.current_device()))
    _REC, _LAST, _ON = rec, None, True
    try:
        yield
    finally:
        _ON = False
        try:
            if rec.rings:
                rec.calibrate(rec.calibration[0][0])
            _LAST = rec.export()
        finally:
            from pre3_tpu_torch.utils import graphs

            graphs.drop_traced()
            rec.rings.clear()
            _REC = None


def export() -> dict:
    """What the tracer holds: while tracing is on, what it has recorded
    so far (the device ring read once, after a synchronize); after,
    the last traced region's."""
    if _ON:
        return _REC.export()
    if _LAST is None:
        raise RuntimeError("nothing traced: export() needs tracing() first")
    return _LAST


def _lib() -> ctypes.CDLL:
    lib = load_library("probe")
    fn = lib.probe_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


class _Ring:
    """One device's probe ring: ``capacity`` (tag, ns) int64 pairs and a
    cursor."""

    def __init__(self, device: torch.device, capacity: int) -> None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("profiling: a probe ring cannot be made "
                               "during a CUDA graph capture")
        self.lib = _lib()
        self.device = device
        self.capacity = capacity
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.slots = torch.zeros((capacity, 2), dtype=torch.int64,
                                 device=device)
        with launch_count.sync_allowed():  # any stream may probe next
            torch.cuda.synchronize(device)

    def launch(self, tag: int) -> None:
        ring = self.slots.data_ptr() if launch_count.counting() else 0
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self.lib.probe_launch(self.cursor.data_ptr(), ring,
                                   self.capacity, tag, stream)
        if rc != 0:
            raise RuntimeError(f"probe kernel launch failed: cudaError {rc}")

    def read(self) -> tuple[list, int]:
        """(the recorded [tag, ns] pairs in slot order, probes dropped),
        after the device's work so far."""
        with launch_count.sync_allowed():
            torch.cuda.synchronize(self.device)
            n = int(self.cursor.item())
            kept = self.slots[:min(n, self.capacity)].cpu().tolist()
        return kept, max(0, n - self.capacity)


class _Span:
    __slots__ = ("rec", "name", "request", "row", "range")

    def __init__(self, rec: _Recorder, name: str, request: bool) -> None:
        self.rec, self.name, self.request = rec, name, request
        self.range = None

    def __enter__(self):
        stack = self.rec.stack()
        parent = stack[-1] if stack else None
        req = next(self.rec.requests) if self.request or parent is None \
            else parent[3]
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.row = [self.name, next(self.rec.ids),
                    parent[1] if parent else 0, req, clock_ns(), None,
                    threading.get_ident()]
        stack.append(self.row)
        self.rec.spans.append(self.row)
        return self

    def __exit__(self, *exc):
        self.row[5] = clock_ns()
        self.rec.stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _Recorder:
    """What one traced region records."""

    def __init__(self) -> None:
        self.capacity = RING_CAPACITY
        self.spans: list = []  # [name, id, parent, request, start, end, tid]
        self.counters: dict = defaultdict(int)
        self.tags: dict[str, int] = {}
        self.host_probes: list = []  # [tag id, ns]
        self.rings: dict[int, _Ring] = {}
        # the calibration's probes, in a ring of their own (a full ring
        # drops no calibration), and per calibration (device,
        # [(host ns before, host ns after)] per eager probe)
        self.clock_ring: _Ring | None = None
        self.calibration: list = []
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def tag(self, tag: str) -> int:
        t = self.tags.get(tag)
        if t is None:
            t = self.tags[tag] = len(self.tags)
        return t

    def ring(self, device: torch.device) -> _Ring:
        index = device.index if device.index is not None else (
            torch.cuda.current_device())
        r = self.rings.get(index)
        if r is None:
            r = self.rings[index] = _Ring(torch.device("cuda", index),
                                          self.capacity)
        return r

    def probe(self, tag: str, device) -> None:
        t = self.tag(tag)
        if device is None or torch.device(device).type != "cuda":
            self.host_probes.append([t, clock_ns()])
            return
        self.ring(torch.device(device)).launch(t)

    def calibrate(self, device: torch.device) -> None:
        """``CALIBRATION_PROBES`` eager probes on ``device``, each between
        two synchronizes and two host clock reads."""
        self.ring(device)  # the probes' ring, made before any calibration
        if self.clock_ring is None:
            self.clock_ring = _Ring(device, 2 * CALIBRATION_PROBES)
        ring, tag = self.clock_ring, self.tag(_CALIBRATE)
        brackets = []
        with launch_count.sync_allowed():
            for _ in range(CALIBRATION_PROBES):
                torch.cuda.synchronize(device)
                h0 = clock_ns()
                ring.launch(tag)
                torch.cuda.synchronize(device)
                brackets.append((h0, clock_ns()))
        self.calibration.append((device, brackets))

    def export(self) -> dict:
        names = {t: name for name, t in self.tags.items()}
        probes, dropped, clock = [], 0, None
        if self.rings:
            device_probes = []
            for r in self.rings.values():
                kept, lost = r.read()
                device_probes += kept
                dropped += lost
            clock = _clock_map(self.clock_ring.read()[0], self.calibration)
            probes = [[names[t], ns, ns - clock["offset_at"](ns)]
                      for t, ns in device_probes]
            clock = {k: v for k, v in clock.items() if k != "offset_at"}
        probes += [[names[t], ns, ns] for t, ns in self.host_probes]
        spans = [dict(name=r[0], id=r[1], parent=r[2], request=r[3],
                      start_ns=r[4], end_ns=r[5], thread=r[6])
                 for r in self.spans if r[5] is not None]
        return dict(spans=spans, by_name=_by_name(spans),
                    counters=dict(self.counters), probes=probes,
                    device=bool(self.rings), clock=clock, dropped=dropped,
                    capacity=self.capacity)


def _clock_map(clock_probes: list, calibration: list) -> dict:
    """Device ns → host ns from the calibration probes ([tag, ns] in
    order): per calibration, the offset (device − host) that every
    bracket allows (the midpoint of their intersection, half its width
    the uncertainty), and between two calibrations the offset
    interpolated in device time."""
    times = iter(ns for _, ns in clock_probes)
    points, widths = [], []
    for _, brackets in calibration:
        d = [next(times) for _ in brackets]
        lo = max(di - h1 for di, (_, h1) in zip(d, brackets))
        hi = min(di - h0 for di, (h0, _) in zip(d, brackets))
        points.append((sum(d) / len(d), (lo + hi) / 2))
        widths.append(abs(hi - lo) / 2)
    (d0, o0), (d1, o1) = points[0], points[-1]
    slope = (o1 - o0) / (d1 - d0) if d1 != d0 else 0.0

    def offset_at(ns: int) -> int:
        return int(round(o0 + slope * (ns - d0)))

    return dict(offset_ns=o0, uncertainty_ns=max(widths), drift_ns=o1 - o0,
                calibrations=len(points), offset_at=offset_at)


def _by_name(spans: list) -> dict:
    """{name: {count, total_ns, self_ns}}; self time is a span's time
    less that of its child spans."""
    child = defaultdict(int)
    for s in spans:
        if s["parent"]:
            child[s["parent"]] += s["end_ns"] - s["start_ns"]
    out: dict = {}
    for s in spans:
        d = s["end_ns"] - s["start_ns"]
        o = out.setdefault(s["name"], dict(count=0, total_ns=0, self_ns=0))
        o["count"] += 1
        o["total_ns"] += d
        o["self_ns"] += d - child[s["id"]]
    return out


def write_chrome_trace(path, exported: dict | None = None) -> None:
    """Write ``exported`` (default: ``export()``) as a Chrome trace: the
    spans on their host threads, each program's begin → end probes as a
    slice on the device's row and every probe as an instant there."""
    ex = export() if exported is None else exported
    events = [dict(name=s["name"], ph="X", pid="host", tid=s["thread"],
                   ts=s["start_ns"] / 1e3,
                   dur=(s["end_ns"] - s["start_ns"]) / 1e3,
                   args=dict(request=s["request"])) for s in ex["spans"]]
    open_at: dict = {}
    for tag, _, host in ex["probes"]:
        events.append(dict(name=tag, ph="i", s="t", pid="device", tid=0,
                           ts=host / 1e3))
        name, _, edge = tag.rpartition(".")
        if edge == "begin":
            open_at[name] = host
        elif edge == "end" and name in open_at:
            start = open_at.pop(name)
            events.append(dict(name=name, ph="X", pid="device", tid=0,
                               ts=start / 1e3, dur=(host - start) / 1e3))
    with open(path, "w") as f:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms"), f)


class StageTimer:
    """Accumulates wall-clock per named stage; thread-safe enough for the
    online pipeline's producer thread (GIL-serialized appends). While
    tracing is on, a stage is also a span of its name."""

    def __init__(self) -> None:
        self._acc: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
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
