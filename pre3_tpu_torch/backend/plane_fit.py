"""RANSAC plane fit → gravity-aligned initial orientation prior.

Port of ``pre3_tpu/backend/plane_fit.py``: fit a plane to the lower
region of the first depth frame with batched RANSAC (all B 3-point
hypotheses at once, [B, N] support, least-squares refit by the smallest
eigenvector of the inlier scatter), take its normal as the gravity
direction, and build the world-from-camera rotation that levels the
camera. The Gumbel draws are an input or come from a generator.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pre3_tpu_torch.geometry.quaternion import r2q
from pre3_tpu_torch.ops.svd3 import _eigvec, sym3_eigvals
from pre3_tpu_torch.utils.topk import stable_topk
from pre3_tpu_torch.vo.ransac import _draw_gumbel


class PlaneFit(NamedTuple):
    normal: torch.Tensor  # [3] unit normal (oriented toward -y: "up")
    offset: torch.Tensor  # [] plane offset: n·x = d
    inliers: torch.Tensor  # [N] bool
    ok: torch.Tensor  # [] bool


def ransac_plane(
    pts: torch.Tensor,  # [N, 3]
    valid: torch.Tensor,  # [N]
    batch: int = 512,
    threshold: float = 0.02,
    min_inliers: int = 30,
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> PlaneFit:
    """RANSAC plane fit. gumbel [batch, N]: the sampling noise; if absent
    it is drawn from ``generator``."""
    n = pts.shape[0]
    if gumbel is None:
        if generator is None:
            raise ValueError("ransac_plane needs gumbel noise or a generator")
        gumbel = _draw_gumbel((batch, n), generator, device=pts.device)
    if tuple(gumbel.shape) != (batch, n):
        raise ValueError(f"gumbel must have shape {(batch, n)}, got "
                         f"{tuple(gumbel.shape)}")
    logits = torch.where(valid, 0.0, -torch.inf)[None, :]
    _, idx = stable_topk(logits + gumbel, 3)  # [B, 3]
    tri = pts[idx]  # [B, 3, 3]
    nrm = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                             dim=-1)
    nn = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.clamp(nn, min=1e-9)
    d = torch.sum(nrm * tri[:, 0], dim=-1)  # [B]
    dist = torch.abs(torch.einsum("bi,ni->bn", nrm, pts) - d[:, None])
    support = torch.sum((dist < threshold) & valid[None], dim=-1)
    support = torch.where(nn[:, 0] > 1e-8, support, -1)
    best = torch.argmax(support).reshape(1)  # first maximum, on device

    # least-squares refit on the winning inliers: the smallest eigenvector
    # of the centered scatter matrix (closed-form 3×3 symmetric eig)
    w = ((torch.index_select(dist, 0, best)[0] < threshold) & valid).to(
        pts.dtype)
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    c = torch.sum(pts * w[:, None], dim=0) / wsum
    pc = (pts - c) * w[:, None]
    cov = pc.T @ pc / wsum
    lam = sym3_eigvals(cov)
    normal = _eigvec(cov, lam[..., 2])  # smallest eigenvalue direction
    # orient "up" (camera y points down ⇒ the floor normal has negative y)
    normal = torch.where(normal[1] > 0, -normal, normal)
    offset = torch.sum(normal * c)
    inl = (torch.abs(pts @ normal - offset) < threshold) & valid
    ok = torch.sum(inl) >= min_inliers
    return PlaneFit(normal=normal, offset=offset, inliers=inl, ok=ok)


def floor_up_direction(
    xyz_image: torch.Tensor,  # [H, W, 3], NaN-safe
    floor_rows_from: float = 0.6,
    batch: int = 512,
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> PlaneFit:
    """RANSAC-fit the floor in the lower image region; fit.normal is the
    camera-frame direction that is world 'up'. gumbel [batch, N] covers
    the N = (H − ⌊H·floor_rows_from⌋)·W region pixels."""
    h = xyz_image.shape[0]
    r0 = int(h * floor_rows_from)
    region = torch.nan_to_num(xyz_image[r0:]).reshape(-1, 3)
    valid = (torch.abs(region[:, 2]) > 0.3) & (
        torch.linalg.vector_norm(region, dim=-1) < 10.0)
    return ransac_plane(region, valid, batch=batch, gumbel=gumbel,
                        generator=generator)


def initial_orientation_from_floor(
    xyz_image: torch.Tensor,  # [H, W, 3] first frame, NaN-safe
    floor_rows_from: float = 0.6,
    batch: int = 512,
    max_tilt_deg: float = 60.0,
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit the floor in the lower part of the first frame and return
    (q0 [4], ok): the camera orientation prior that maps the floor normal
    to world 'up'. Identity with ok=False when no plane is found or the
    fit tilts more than max_tilt_deg (a wall, not a floor)."""
    fit = floor_up_direction(xyz_image, floor_rows_from, batch,
                             gumbel=gumbel, generator=generator)
    up_cam = fit.normal  # camera-frame direction that is world "up"
    eye = torch.eye(3, dtype=up_cam.dtype, device=up_cam.device)
    up_world = -eye[1]  # y-down convention
    cth = torch.dot(up_cam, up_world)
    tilt = torch.acos(torch.clamp(cth, -1.0, 1.0))
    ok = fit.ok & (tilt < math.radians(max_tilt_deg))
    # rotation taking up_cam → up_world, minimal angle (Rodrigues)
    v = torch.linalg.cross(up_cam, up_world, dim=-1)
    s = torch.linalg.vector_norm(v)
    zero = torch.zeros_like(v[0])
    vx = torch.stack([
        torch.stack([zero, -v[2], v[1]]),
        torch.stack([v[2], zero, -v[0]]),
        torch.stack([-v[1], v[0], zero]),
    ])
    r = eye + vx + vx @ vx * ((1 - cth) / torch.clamp(s * s, min=1e-12))
    r = torch.where(s < 1e-6, eye, r)
    q = torch.where(ok, r2q(r), torch.cat([eye[0, :1], torch.zeros_like(v)]))
    return q, ok
