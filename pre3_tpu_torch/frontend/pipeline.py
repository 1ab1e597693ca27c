"""Frontend pipeline: detect → describe → depth-lift, batched over frames.

Port of ``pre3_tpu/frontend/pipeline.py`` (``extract_features``, FAST +
patches, and ``extract_features_sift``). The reference
extracts one frame per call and is vmapped by its callers; here the frame
axis is explicit, so a whole sequence's frontend is one batch of launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.frontend.depth_lift import lift
from pre3_tpu_torch.frontend.fast import detect
from pre3_tpu_torch.frontend.patches import extract_patch_descriptors
from pre3_tpu_torch.frontend.sift import extract_sift


class Features(NamedTuple):
    """Fixed-capacity feature set (masked); leading frame axis optional."""

    uv: torch.Tensor  # [..., K, 2]
    desc: torch.Tensor  # [..., K, D]
    xyz: torch.Tensor  # [..., K, 3] camera-frame 3D (0 where invalid)
    valid: torch.Tensor  # [..., K] bool
    score: torch.Tensor  # [..., K] detector response


def extract_features(
    intensity: torch.Tensor,  # [F, H, W] float
    xyz: torch.Tensor,  # [F, H, W, 3], NaNs allowed
    confidence: torch.Tensor,  # [F, H, W]
    threshold: float = 0.06,
    max_features: int = 256,
    patch: int = 11,
) -> Features:
    """FAST + patch descriptors + depth lift for F frames at once; every
    field of the result has the leading frame axis F."""
    _check_frames("extract_features", intensity, xyz, confidence)
    corners = detect(intensity, threshold=threshold, max_corners=max_features)
    desc = extract_patch_descriptors(intensity, corners.uv, patch=patch)
    lifted = lift(corners.uv, corners.valid, torch.nan_to_num(xyz), confidence)
    return Features(
        uv=corners.uv, desc=desc, xyz=lifted.xyz, valid=lifted.valid,
        score=corners.score,
    )


def extract_features_sift(
    intensity: torch.Tensor,  # [F, H, W] float
    xyz: torch.Tensor,  # [F, H, W, 3], NaNs allowed
    confidence: torch.Tensor,  # [F, H, W]
    n_octaves: int = 3,
    keypoints_per_octave: int = 96,
    peak_thresh: float = 0.004,
    upright: bool = True,
) -> Features:
    """SIFT variant of the frontend (the reference's primary extractor):
    DoG keypoints + 128-D descriptors + depth lift for F frames at once,
    K = n_octaves·keypoints_per_octave per frame (288 by default)."""
    _check_frames("extract_features_sift", intensity, xyz, confidence)
    f = extract_sift(intensity, n_octaves=n_octaves,
                     keypoints_per_octave=keypoints_per_octave,
                     peak_thresh=peak_thresh, upright=upright)
    lifted = lift(f.uv, f.valid, torch.nan_to_num(xyz), confidence)
    return Features(uv=f.uv, desc=f.desc, xyz=lifted.xyz, valid=lifted.valid,
                    score=f.score)


def extract_sequences(extract, intensity: torch.Tensor, xyz: torch.Tensor,
                      confidence: torch.Tensor, **kwargs) -> Features:
    """``extract`` (``extract_features`` or ``extract_features_sift``)
    over S sequences of F frames ([S, F, H, W] ...) as one call over the
    S·F frames (the SIFT frontend runs them in its 64-frame chunks);
    every field of the result has the leading axes [S, F]. The
    reference's tools/measure_batch.py maps its frontend over the
    sequences."""
    s, f = intensity.shape[:2]
    out = extract(intensity.flatten(0, 1), xyz.flatten(0, 1),
                  confidence.flatten(0, 1), **kwargs)
    return Features(*(x.unflatten(0, (s, f)) for x in out))


def _check_frames(name, intensity, xyz, confidence) -> None:
    if intensity.dim() != 3 or xyz.shape != (*intensity.shape, 3) or (
        confidence.shape != intensity.shape
    ):
        raise ValueError(
            f"{name} takes intensity [F, H, W], xyz [F, H, W, 3] and "
            f"confidence [F, H, W]; got {tuple(intensity.shape)}, "
            f"{tuple(xyz.shape)}, {tuple(confidence.shape)}"
        )
