"""The step's host-built constants, kept on their device.

The EKF step and the frontend use a few small constants built on the host
(blur taps, band matrices, the process noise, the NCC grid). Each is
built and copied once per (key, device) and the same device tensor is
used ever after (``cached_constant``). A copy made on every call would
not do inside a CUDA graph: the graph's copy node keeps the address of a
pinned temporary that is freed when the call returns, and a later pinned
allocation (a frame staging buffer) may take that block, so that every
replay would read it as the constant. The one copy is staged in pinned
memory and made asynchronously on the current stream: a plain
``tensor.to("cuda")`` from pageable memory waits for the card.
"""

from __future__ import annotations

from typing import Callable

import torch

_CONSTANTS: dict = {}


def cached_constant(key, build: Callable[[], torch.Tensor],
                    device: torch.device | str) -> torch.Tensor:
    """``build()`` (a CPU tensor) on ``device``, built and copied on the
    first call for (key, device) and the same tensor ever after. Callers
    must not write to it. Raises if the first call falls inside a CUDA
    graph capture (a program's warm-up builds its constants first)."""
    device = torch.device(device)
    k = (key, device)
    t = _CONSTANTS.get(k)
    if t is None:
        if device.type != "cuda":
            t = _CONSTANTS[k] = build().to(device)
            return t
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"constant {key!r} first built during a CUDA "
                               "graph capture")
        t = _CONSTANTS[k] = build().pin_memory().to(device, non_blocking=True)
        # copied on the current stream; any stream that follows the
        # default one may read it from now on
        torch.cuda.default_stream(device).wait_stream(
            torch.cuda.current_stream(device))
    return t
