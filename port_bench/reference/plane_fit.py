"""The bootstrap's orientation prior as the configuration defines it,
written plainly: a RANSAC fit of the floor plane in the lower part of
frame 0's xyz image, its normal taken as world up, and the rotation
that levels the camera.

The definition:

* the region: the rows from ⌊0.6·H⌋ down, every column; a point is
  valid where |z| > 0.3 m and its range is under 10 m;
* 512 hypotheses, each the three valid points of largest
  ``gumbel + logit`` (logit 0 where valid, −∞ elsewhere; ties to the
  lower index) from one standard Gumbel draw [512, N] (``draw``, the
  step's own draw made in float32 from the generator);
* a hypothesis: the plane through its three points (the unit normal of
  (p1 − p0) × (p2 − p0), the cross product's norm held at 1e-9 or
  more); its support, the valid points within 0.02 m, or −1 where the
  cross product's norm is 1e-8 or less; the first of the most supported
  wins;
* the refit: the winner's valid inliers' centroid and the eigenvector
  of the smallest eigenvalue of their scatter (divided by their count,
  at least 1e-9), turned so that its y is not positive ("up", since the
  camera's y points down); ``ok`` where 30 or more valid points lie
  within 0.02 m of the refitted plane;
* the prior: with up_w = −e_y and c = n·up_w, the tilt acos(c) must be
  under 60° (a wall is not a floor) and the fit ``ok``; then
  R = I + [v]× + [v]×²·(1 − c)/max(|v|², 1e-12) with v = n × up_w (I
  where |v| < 1e-6), and q0 its quaternion (w ≥ 0); else the identity.

Departures: none in what is computed; the eigenvector comes from a
float64 ``eigh``.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.geometry import COLS, ROWS, matrix_quaternion
from port_bench.reference.vo import gumbel, topk_stable

BATCH = 512
FLOOR_FROM = 0.6
THRESHOLD = 0.02
MIN_INLIERS = 30
MAX_TILT_DEG = 60.0


def draw(gen: torch.Generator, device) -> torch.Tensor:
    """The fit's draw, [512, N] for the N region pixels of a frame."""
    return gumbel((BATCH, (ROWS - int(ROWS * FLOOR_FROM)) * COLS), gen,
                  device)


def floor_normal(xyz: torch.Tensor, g: torch.Tensor):
    """(unit normal n, ok) of the floor fitted in xyz [H, W, 3]."""
    h = xyz.shape[0]
    pts = xyz[int(h * FLOOR_FROM):].reshape(-1, 3)
    valid = (pts[:, 2].abs() > 0.3) & (
        torch.linalg.vector_norm(pts, dim=-1) < 10.0)
    logits = torch.where(valid, 0.0, -math.inf).to(g.dtype)
    tri = pts[topk_stable(logits[None] + g, 3)]  # [B, 3, 3]
    cross = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                               dim=-1)
    size = torch.linalg.vector_norm(cross, dim=-1)
    n = cross / size.clamp(min=1e-9)[:, None]
    dist = (pts @ n.T - (n * tri[:, 0]).sum(-1)).abs().T  # [B, N]
    support = ((dist < THRESHOLD) & valid).sum(-1)
    support = torch.where(size > 1e-8, support, -1)
    best = int(torch.argmax(support))
    w = ((dist[best] < THRESHOLD) & valid).to(pts.dtype)
    count = w.sum().clamp(min=1e-9)
    c = (pts * w[:, None]).sum(0) / count
    d = (pts - c) * w[:, None]
    normal = torch.linalg.eigh(d.T @ d / count).eigenvectors[:, 0]
    normal = torch.where(normal[1] > 0, -normal, normal)
    inliers = ((pts @ normal - (normal * c).sum()).abs() < THRESHOLD) & valid
    return normal, inliers.sum() >= MIN_INLIERS


def initial_orientation(xyz: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """q0 [4] from frame 0's xyz image and the fit's draw g."""
    n, ok = floor_normal(xyz, g)
    up = torch.tensor([0.0, -1.0, 0.0], dtype=n.dtype, device=n.device)
    c = (n * up).sum()
    ok = ok & (torch.acos(c.clamp(-1, 1)) < math.radians(MAX_TILT_DEG))
    v = torch.linalg.cross(n, up, dim=-1)
    s2 = (v * v).sum()
    vx = torch.zeros(3, 3, dtype=n.dtype, device=n.device)
    vx[0, 1], vx[0, 2], vx[1, 2] = -v[2], v[1], -v[0]
    vx = vx - vx.T
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    r = eye + vx + vx @ vx * (1 - c) / s2.clamp(min=1e-12)
    r = torch.where(s2.sqrt() < 1e-6, eye, r)
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=n.dtype,
                            device=n.device)
    return torch.where(ok, matrix_quaternion(r), identity)
