"""Depth-lifting of 2D keypoints through the per-pixel XYZ image.

Port of ``pre3_tpu/frontend/depth_lift.py``: for every keypoint, look up
the per-pixel 3D point and invalidate it when the depth is non-finite,
closer than 0.4 m, or the confidence is below 0.5·max(confidence) of its
own frame. Batched over leading frame axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LiftedFeatures(NamedTuple):
    uv: torch.Tensor  # [..., K, 2] pixel positions (u=col, v=row)
    xyz: torch.Tensor  # [..., K, 3] camera-frame 3D points (0 where invalid)
    valid: torch.Tensor  # [..., K] bool


def lift(
    uv: torch.Tensor,  # [..., K, 2]
    valid: torch.Tensor,  # [..., K]
    xyz_image: torch.Tensor,  # [..., H, W, 3]
    confidence: torch.Tensor | None = None,  # [..., H, W]
    min_range: float = 0.4,
    confidence_ratio: float = 0.5,
) -> LiftedFeatures:
    """Sample xyz at the nearest pixel and gate by range/confidence/NaN."""
    h, w = xyz_image.shape[-3:-1]
    cols = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, w - 1)
    rows = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, h - 1)
    pix = rows * w + cols  # [..., K]
    flat = xyz_image.flatten(-3, -2)  # [..., H·W, 3]
    p = torch.gather(flat, -2, pix[..., None].expand(*pix.shape, 3))
    finite = torch.all(torch.isfinite(p), dim=-1)
    p = torch.where(finite[..., None], p, 0.0)
    d = torch.linalg.vector_norm(p, dim=-1)
    ok = valid & finite & (d >= min_range)
    if confidence is not None:
        conf_flat = confidence.flatten(-2)
        conf = torch.gather(conf_flat, -1, pix)
        conf_max = torch.amax(conf_flat, dim=-1, keepdim=True)  # per frame
        ok = ok & (conf > confidence_ratio * conf_max)
    return LiftedFeatures(uv=uv, xyz=p, valid=ok)
