"""Checkpoints of the SLAM filter.

Port of ``pre3_tpu/utils/checkpoint.py``, with the same npz layout: one
``state__<field>`` array per EkfState field, ``step``, ``key`` and a JSON
``__meta__``. The reference stores its PRNG key under ``key``; the port
stores its ``torch.Generator`` state there (a uint8 array), so a resumed
run draws the same numbers as the run it continues.

``load_state`` also reads a snapshot the JAX package wrote: its
``state__*`` arrays and step load onto the given device; its threefry key
cannot seed a ``torch.Generator``, so the generator state comes back None.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from pre3_tpu_torch.ekf.state import EkfState


def save_state(path: str, state: EkfState, step: int,
               generator: torch.Generator | None = None,
               extra: dict[str, Any] | None = None) -> None:
    """Write ``state`` (read back from its device), the host step index
    and the generator's state to ``path``."""
    arrays = {f"state__{f}": getattr(state, f).detach().cpu().numpy()
              for f in state._fields}
    arrays["step"] = np.asarray(step)
    arrays["key"] = (np.zeros(0, np.uint8) if generator is None
                     else generator.get_state().numpy())
    meta = json.dumps(extra or {})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __meta__=np.frombuffer(meta.encode(), np.uint8), **arrays)


def load_state(
    path: str, device: torch.device | str = "cuda",
) -> tuple[EkfState, int, torch.Tensor | None, dict]:
    """(state on ``device``, step, generator state or None, meta)."""
    with np.load(path) as z:
        fields = {f: torch.as_tensor(z[f"state__{f}"]).to(device)
                  for f in EkfState._fields}
        step = int(z["step"])
        key = z["key"]
        meta = json.loads(bytes(z["__meta__"]).decode())
    gen_state = (torch.from_numpy(key.copy())
                 if key.dtype == np.uint8 and key.size else None)
    return EkfState(**fields), step, gen_state, meta
