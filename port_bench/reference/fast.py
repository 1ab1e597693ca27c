"""The FAST frontend as the configuration defines it, written plainly:
FAST-9 corners, the strongest ``max_features`` per frame, 11×11 patch
descriptors, and the lift of each corner through the frame's xyz image.

The definition (Rosten's ``fast_corner_detect_9.m`` and
``fast_nonmax.m``, as 3PRE runs them):

* the ring: the 16 pixels of the Bresenham circle of radius 3,
  clockwise from 12 o'clock;
* a corner: 9 or more contiguous ring pixels (the ring closes on
  itself) all brighter than the centre by more than the threshold, or
  all darker by more than it; pixels within 3 of the border are never
  corners;
* its score, the arc score: over every run of 9 contiguous ring pixels
  that passes the test, and over both polarities, the largest sum of
  the run's differences beyond the threshold (|ring − centre| − t);
* non-max suppression: a corner stays where its score is at least each
  of its 8 neighbours' (neighbours outside the image do not count);
* the ``max_features`` highest scores of the frame, ties to the lower
  index in row-major order; a slot with no corner (score 0) is invalid;
* descriptor: the patch of ``patch``×``patch`` pixels about the corner,
  row by row, sampled bilinearly with the positions held in
  [0, size − 1.001], less its mean and divided by its norm (at least
  1e-8), so that NCC is an inner product;
* lift: as the SIFT frontend's (``sift.lift``): the xyz pixel nearest
  the corner, kept where finite, at least 0.4 m away, and of a
  confidence above half the frame's largest.

Departures: none in what is computed; the sums run in float64.
"""

from __future__ import annotations

import torch

from port_bench.reference.sift import Features, lift

RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
        (-3, -1))  # (row, column) offsets
ARC = 9
BORDER = 3


def corner_scores(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """[F, H, W] arc score of every pixel (0 where no corner)."""
    n_f, h, w = img.shape
    centre = img[:, BORDER:h - BORDER, BORDER:w - BORDER]
    ring = [img[:, BORDER + dr:h - BORDER + dr, BORDER + dc:w - BORDER + dc]
            for dr, dc in RING]
    best = torch.zeros_like(centre)
    for sign in (1.0, -1.0):
        excess = [sign * (p - centre) - threshold for p in ring]
        for start in range(len(RING)):
            run = [excess[(start + i) % len(RING)] for i in range(ARC)]
            passes = torch.stack([e > 0 for e in run]).all(0)
            total = torch.stack(run).sum(0)
            best = torch.where(passes & (total > best), total, best)
    out = torch.zeros_like(img)
    out[:, BORDER:h - BORDER, BORDER:w - BORDER] = best
    return out


def suppress(score: torch.Tensor) -> torch.Tensor:
    """Scores that are at least each in-image neighbour's; else 0."""
    n_f, h, w = score.shape
    keep = torch.ones_like(score, dtype=torch.bool)
    pad = torch.full((n_f, h + 2, w + 2), -torch.inf, dtype=score.dtype,
                     device=score.device)
    pad[:, 1:-1, 1:-1] = score
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                keep &= score >= pad[:, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]
    return torch.where(keep, score, 0.0)


def offsets(size: int, like: torch.Tensor) -> torch.Tensor:
    """[size², 2] (u, v) offsets about a patch centre, row by row."""
    o = torch.arange(size, dtype=like.dtype, device=like.device) - (
        size - 1) / 2
    v, u = torch.meshgrid(o, o, indexing="ij")
    return torch.stack([u, v], -1).reshape(-1, 2)


def sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear read of img [H, W] (or of N images [N, H, W], uv then
    [N, ...]) at uv [..., 2] held in [0, size − 1.001]."""
    h, w = img.shape[-2:]
    uv = torch.nan_to_num(uv)  # a slot out of view reads anything
    u = uv[..., 0].clamp(0, w - 1.001)
    v = uv[..., 1].clamp(0, h - 1.001)
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    r, c = v0.long(), u0.long()
    if img.dim() == 3:
        n = torch.arange(img.shape[0], device=img.device).reshape(
            -1, *([1] * (u.dim() - 1)))
        at = lambda dr, dc: img[n, r + dr, c + dc]  # noqa: E731
    else:
        at = lambda dr, dc: img[r + dr, c + dc]  # noqa: E731
    return ((at(0, 0) * (1 - fu) + at(0, 1) * fu) * (1 - fv)
            + (at(1, 0) * (1 - fu) + at(1, 1) * fu) * fv)


def normalise(vals: torch.Tensor) -> torch.Tensor:
    """Less the mean, over the norm (held at 1e-8 or more)."""
    vals = vals - vals.mean(-1, keepdim=True)
    return vals / torch.linalg.vector_norm(vals, dim=-1, keepdim=True).clamp(
        min=1e-8)


def patch_descriptors(img: torch.Tensor, uv: torch.Tensor,
                      patch: int) -> torch.Tensor:
    """[F, K, patch²] zero-mean unit-norm patches of img [F, H, W] about
    uv [F, K, 2]."""
    return normalise(sample(img, uv[..., None, :] + offsets(patch, uv)))


def fast_features(intensity, xyz, conf, threshold: float, max_features: int,
                  patch: int, dtype=torch.float64) -> Features:
    """The frontend over [F, H, W] frames, in ``dtype``."""
    img = intensity.to(dtype)
    n_f, h, w = img.shape
    score = suppress(corner_scores(img, threshold)).reshape(n_f, -1)
    order = torch.sort(score, dim=-1, descending=True, stable=True)
    top = order.indices[:, :max_features]
    best = order.values[:, :max_features]
    uv = torch.stack([top % w, top // w], -1).to(dtype)
    valid = best > 0
    desc = patch_descriptors(img, uv, patch)
    p, ok = lift(uv, valid, torch.nan_to_num(xyz.to(dtype)), conf.to(dtype))
    return Features(uv=uv, desc=desc, xyz=p, valid=ok, score=best)
