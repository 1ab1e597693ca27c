"""State carried across: the reference's NamedTuples ↔ the port's.

The engine has no learned weights; its state is features, matches, random
draws, poses, the EKF state and trajectories. These helpers turn the JAX
package's NamedTuples, given as numpy arrays (``Features``, ``Matches``,
``Pose``, ``Trajectory``, ``VoStep``, ``RigidFit``, ``RansacResult``,
``EkfState``, ``Observations``, ``StepStats``, ``StepRecord``,
``SlamTrajectory``, ``Camera``, ``SiftFeatures``, and the backend's
``BaProblem``, ``BaResult``, ``KeyframeSet`` and ``TrackTable``), into
the port's NamedTuples of tensors on a given device (the card unless the
caller names another), and back into numpy. The loop-closure factors
(``lcp``) are a plain tuple of arrays and convert as one. Matching is by
type name and fields, so this module imports nothing of the JAX package.
A ``Camera`` keeps its intrinsics as Python numbers on the port's side.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pre3_tpu_torch.backend.ba import BaProblem, BaResult
from pre3_tpu_torch.backend.keyframes import KeyframeSet
from pre3_tpu_torch.backend.tracks import TrackTable
from pre3_tpu_torch.ekf.measurement import Observations
from pre3_tpu_torch.ekf.slam import SlamTrajectory, StepRecord, StepStats
from pre3_tpu_torch.ekf.state import EkfState
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.frontend.sift import SiftFeatures
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.se3 import Pose
from pre3_tpu_torch.ops.matching import Matches
from pre3_tpu_torch.vo.dead_reckoning import Trajectory, VoStep
from pre3_tpu_torch.vo.ransac import RansacResult
from pre3_tpu_torch.vo.rigid import RigidFit

_PORT_TYPES: dict[tuple[str, tuple[str, ...]], type] = {
    (cls.__name__, cls._fields): cls
    for cls in (Features, Matches, Pose, Trajectory, VoStep, RansacResult,
                RigidFit, EkfState, Observations, StepStats, StepRecord,
                SlamTrajectory, Camera, SiftFeatures, BaProblem, BaResult,
                KeyframeSet, TrackTable)
}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(value: Any, device: torch.device | str = "cuda") -> Any:
    """numpy arrays (or NamedTuples of them) → tensors on ``device``.

    A NamedTuple becomes the port's type of the same name and fields; any
    other NamedTuple keeps its type; plain tuples and lists keep theirs.
    None stays None."""
    if value is None:
        return None
    if _is_namedtuple(value):
        cls = _PORT_TYPES.get((type(value).__name__, value._fields),
                              type(value))
        if cls is Camera:  # intrinsics as floats, image size as ints
            return Camera(*(float(v) for v in value[:5]),
                          *(int(v) for v in value[5:]))
        return cls(*(to_torch(v, device) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(to_torch(v, device) for v in value)
    return torch.tensor(np.asarray(value), device=device)  # a copy


def to_numpy(value: Any) -> Any:
    """Tensors (or NamedTuples of them) → numpy arrays, same structure.
    The result feeds the reference's NamedTuple: ``JaxType(*to_numpy(x))``.
    A Python float becomes an np.float32 scalar; ints and None stay."""
    if _is_namedtuple(value):
        return type(value)(*(to_numpy(v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(to_numpy(v) for v in value)
    if value is None or isinstance(value, (bool, int)):
        return value
    if isinstance(value, float):
        return np.float32(value)
    return value.detach().cpu().numpy()
