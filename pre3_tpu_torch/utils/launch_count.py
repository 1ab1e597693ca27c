"""Kernel launch counts kept where the kernels run.

Each hand kernel (K1, K2) takes a pointer to an int32 counter on its
device and adds one to it from block 0, thread 0, each time it runs. So
the count holds every run of the kernel: an eager launch and every
replay of a CUDA graph that captured one. ``Counted(fn)`` wraps a
kernel's wrapper; ``fn.launches`` reads the count (a synchronising read
of the device counters) and ``fn.launches = 0`` sets it. On the CPU no
kernel runs and the count stays where it was set.

Launches made inside ``uncounted()`` (in that thread) pass no counter
and are not counted: a step program's warm-up, set-up whose results are
thrown away, runs so. The tracer's probes (``utils/profiling``) record
nothing there either.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

_LOCAL = threading.local()


@contextlib.contextmanager
def uncounted():
    """Launches in this thread inside the block are not counted."""
    prev = getattr(_LOCAL, "off", False)
    _LOCAL.off = True
    try:
        yield
    finally:
        _LOCAL.off = prev


def counting() -> bool:
    """Whether launches in this thread are counted here (outside
    ``uncounted()``)."""
    return not getattr(_LOCAL, "off", False)


class Counted:
    """A kernel wrapper with its launch count (see the module
    docstring)."""

    def __init__(self, fn) -> None:
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._counters: dict[int, torch.Tensor] = {}
        self._base = 0

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def pointer(self, device: torch.device) -> int:
        """The address the kernel counts its run at on ``device``: the
        counter's, or 0 (null, not counted) inside ``uncounted()``."""
        ptr = self.counter(device).data_ptr()  # made here, not in a capture
        return ptr if counting() else 0

    def counter(self, device: torch.device) -> torch.Tensor:
        """The [1] int32 counter the kernel adds to on ``device``, made
        on the first launch there (a step program's warm-up precedes its
        capture)."""
        index = torch.device(device).index
        index = torch.cuda.current_device() if index is None else index
        c = self._counters.get(index)
        if c is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{self.__name__}: first launch on "
                                   f"cuda:{index} inside a graph capture")
            c = self._counters[index] = torch.zeros(
                1, dtype=torch.int32, device=f"cuda:{index}")
            # made on the current stream; any stream may launch next
            with sync_allowed():
                torch.cuda.synchronize(index)
        return c

    @property
    def launches(self) -> int:
        """Runs of the kernel since the count was set: reads the device
        counters, after every stream of their devices has finished."""
        n = 0
        with sync_allowed():  # a deliberate read
            for index, c in self._counters.items():
                torch.cuda.synchronize(index)
                n += int(c.item())
        return self._base + n

    @launches.setter
    def launches(self, n: int) -> None:
        with sync_allowed():
            for index, c in self._counters.items():
                torch.cuda.synchronize(index)
                c.zero_()
                torch.cuda.synchronize(index)
        self._base = int(n)


@contextlib.contextmanager
def sync_allowed():
    """torch's sync debug mode suspended: the counters' reads and writes
    wait for the device on purpose."""
    if not torch.cuda.is_available():
        yield
        return
    debug = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(debug)
