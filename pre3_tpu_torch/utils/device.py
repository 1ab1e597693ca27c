"""Host constants on a device without waiting for it.

A plain ``tensor.to("cuda")`` (or ``torch.tensor([...], device="cuda")``)
copies from pageable host memory and waits for the card. The EKF step
needs a few small host-built constants per call, so they are staged in
pinned memory and copied asynchronously on the current stream.
"""

from __future__ import annotations

import torch


def to_device(a: torch.Tensor, device: torch.device | str) -> torch.Tensor:
    """``a`` (a CPU tensor) on ``device``; a CUDA copy never syncs."""
    device = torch.device(device)
    if device.type != "cuda":
        return a.to(device)
    return a.pin_memory().to(device, non_blocking=True)
