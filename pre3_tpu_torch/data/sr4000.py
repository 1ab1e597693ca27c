"""SR4000 ToF camera frame type and image size.

Copy of the ``Frame`` / ``H`` / ``W`` part of ``pre3_tpu/data/sr4000.py``
(the .dat reader is not ported yet). Host-side numpy: frames are small
(176×144); device work starts downstream, in ``frontend/pipeline.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

H, W = 144, 176


class Frame(NamedTuple):
    """One SR4000 frame, camera-convention xyz (x right, y down, z forward)."""

    intensity: np.ndarray  # [H, W] float32 in [0, 1]
    xyz: np.ndarray  # [H, W, 3] float32, camera frame, NaN where invalid
    confidence: np.ndarray  # [H, W] float32
    timestamp: float  # seconds
