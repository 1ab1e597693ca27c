"""FAST-9 corner detection as dense tensor ops, batched over frames.

Port of ``pre3_tpu/frontend/fast.py``. The 16-pixel Bresenham ring is a
[16, ..., H, W] stack of wrap-around shifted images, the ≥9-contiguous test
a wrap-around windowed sum, and non-max suppression a 3×3 max pool. Every
function takes any number of leading frame axes before [H, W].
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pre3_tpu_torch.utils.topk import stable_topk

# Bresenham circle of radius 3, clockwise from 12 o'clock: (drow, dcol).
_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9  # default: FAST-9


class Corners(NamedTuple):
    """Fixed-capacity corner list (masked)."""

    uv: torch.Tensor  # [..., K, 2] (u=col, v=row) float32
    score: torch.Tensor  # [..., K] float32
    valid: torch.Tensor  # [..., K] bool


def _ring_stack(img: torch.Tensor) -> torch.Tensor:
    """[16, ..., H, W] of ring-shifted copies; borders are handled by the
    validity margin in fast_score_map()."""
    shifted = [torch.roll(img, shifts=(-dr, -dc), dims=(-2, -1))
               for dr, dc in _RING]
    return torch.stack(shifted, dim=0)


def fast_score_map(
    img: torch.Tensor, threshold: float = 0.05, arc: int = ARC
) -> torch.Tensor:
    """Per-pixel FAST-n corner score (0 where not a corner), n = arc.

    Score = max over (bright, dark) polarity of the summed threshold excess
    on the contiguous arc.
    """
    ring = _ring_stack(img)  # [16, ..., H, W]
    center = img[None]
    bright = ring - center - threshold
    dark = center - ring - threshold

    def arc_score(excess: torch.Tensor) -> torch.Tensor:
        is_on = (excess > 0).to(torch.float32)
        # wrap-around: windows of length arc over a ring of 16
        on2 = torch.cat([is_on, is_on[: arc - 1]], dim=0)
        pos = torch.clamp(excess, min=0.0)
        ex2 = torch.cat([pos, pos[: arc - 1]], dim=0)
        cs_on = torch.cumsum(on2, dim=0)
        cs_ex = torch.cumsum(ex2, dim=0)
        zeros = torch.zeros_like(cs_on[:1])
        cs_on = torch.cat([zeros, cs_on], dim=0)
        cs_ex = torch.cat([zeros, cs_ex], dim=0)
        win_on = cs_on[arc:] - cs_on[:-arc]  # [16, ..., H, W]
        win_ex = cs_ex[arc:] - cs_ex[:-arc]
        full = win_on >= arc - 0.5
        return torch.amax(torch.where(full, win_ex, 0.0), dim=0)

    score = torch.maximum(arc_score(bright), arc_score(dark))
    # Invalidate the 3-pixel border (the ring wraps around the image edge).
    h, w = img.shape[-2:]
    rows = torch.arange(h, device=img.device)[:, None]
    cols = torch.arange(w, device=img.device)[None, :]
    margin = (rows >= 3) & (rows < h - 3) & (cols >= 3) & (cols < w - 3)
    return torch.where(margin, score, 0.0)


def nonmax_suppress(score: torch.Tensor) -> torch.Tensor:
    """Keep pixels that are the max of their 3×3 neighbourhood (-inf
    padding at the border, as the reference's SAME reduce_window)."""
    lead, (h, w) = score.shape[:-2], score.shape[-2:]
    flat = score.reshape(-1, 1, h, w)
    local_max = F.max_pool2d(flat, kernel_size=3, stride=1, padding=1)
    return torch.where(score >= local_max.reshape(*lead, h, w), score, 0.0)


def detect(
    img: torch.Tensor, threshold: float = 0.05, max_corners: int = 256,
    arc: int = ARC,
) -> Corners:
    """FAST-n detection → top-K corners per frame with scores (fixed K)."""
    score = nonmax_suppress(fast_score_map(img, threshold, arc=arc))
    w = img.shape[-1]
    vals, idx = stable_topk(score.flatten(-2), max_corners)
    rows = idx // w
    cols = idx % w
    uv = torch.stack([cols, rows], dim=-1).to(torch.float32)
    return Corners(uv=uv, score=vals, valid=vals > 0)
