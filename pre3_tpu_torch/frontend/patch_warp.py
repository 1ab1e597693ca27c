"""Warped-patch appearance prediction for NCC map matching.

Port of ``pre3_tpu/frontend/patch_warp.py``. Each map feature stores the
raw intensity patch and camera pose captured at initialization; before
NCC matching that patch is re-rendered into the current view, assuming
the feature lies on a plane whose normal points along the initial viewing
ray. Each target pixel is traced exactly: undistort → ray → ray/plane
intersection in world → reproject + distort into the init view →
bilinear sample of the init patch.

The reference reads the init patch by a one-hot contraction ([P², PB²]
weights per feature), a TPU form; here the same four taps are gathered,
with the same clip and floor; a NaN position reads the first tap (its
weights stay NaN), never an index outside the patch. Every function is
batched over features.
"""

from __future__ import annotations

import torch

from pre3_tpu_torch.frontend.patches import bilinear_sample
from pre3_tpu_torch.geometry.camera import (
    Camera, distort, project_point, unproject,
)
from pre3_tpu_torch.geometry.quaternion import qconj, qrotate


def _offsets(size: int, like: torch.Tensor) -> torch.Tensor:
    """[size, size, 2] (u, v) pixel offsets about a patch center, u along
    the last axis (``meshgrid(..., indexing="xy")``)."""
    offs = torch.arange(size, dtype=like.dtype, device=like.device) - (
        (size - 1) / 2.0)
    gv, gu = torch.meshgrid(offs, offs, indexing="ij")
    return torch.stack([gu, gv], dim=-1)


def extract_raw_patches(img: torch.Tensor, uv: torch.Tensor,
                        size: int = 21) -> torch.Tensor:
    """[K, size, size] raw (unnormalized) intensity patches of img [H, W]
    centered at uv [K, 2]: the init-appearance record of a new feature."""
    pts = uv[:, None, None, :] + _offsets(size, uv)[None]  # [K, S, S, 2]
    return bilinear_sample(img, pts)


def _plane_point(o_w: torch.Tensor, d_w: torch.Tensor, p_w: torch.Tensor,
                 n_w: torch.Tensor) -> torch.Tensor:
    """Ray/plane intersection X = o + s·d with s clamped to [1e-3, 1e3].
    o_w, p_w, n_w [..., 3] broadcast against the rays d_w [..., M, 3]."""
    denom = torch.sum(d_w * n_w[..., None, :], dim=-1)
    safe = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    s = torch.sum((p_w - o_w) * n_w, dim=-1)[..., None] / safe
    s = torch.clamp(s, 1e-3, 1e3)
    return o_w[..., None, :] + s[..., None] * d_w


def predict_patches(
    cam: Camera,
    init_patches: torch.Tensor,  # [K, PB, PB] raw patches at initialization
    init_uvs: torch.Tensor,  # [K, 2] pixel of each feature at init
    init_cams: torch.Tensor,  # [K, 7] (t_w, q_wc) pose at init
    cur_cam: torch.Tensor,  # [7] (t_w, q_wc) current pose
    lms_w: torch.Tensor,  # [K, 3] landmark positions, world frame
    h_pred: torch.Tensor,  # [K, 2] predicted pixels in the current view
    patch: int = 11,
) -> torch.Tensor:
    """[K, patch²] zero-mean unit-norm predicted appearance of every map
    feature: a plane through the landmark with normal along the initial
    view ray, warped by the relative camera motion."""
    k = init_patches.shape[0]
    t_i, q_i = init_cams[:, 0:3], init_cams[:, 3:7]
    t_c, q_c = cur_cam[0:3], cur_cam[3:7]
    n_w = lms_w - t_i
    n_w = n_w / torch.clamp(torch.linalg.vector_norm(n_w, dim=-1,
                                                     keepdim=True), min=1e-9)

    grid_uv = h_pred[:, None, :] + _offsets(patch, h_pred).reshape(1, -1, 2)
    d_c = unproject(cam, grid_uv)  # [K, P², 3] rays, current camera frame
    d_w = qrotate(q_c, d_c)
    x_w = _plane_point(t_c.expand(k, 3), d_w, lms_w, n_w)  # [K, P², 3]
    x_i = qrotate(qconj(q_i)[:, None, :], x_w - t_i[:, None, :])
    uv_i = distort(cam, project_point(cam, x_i))  # [K, P², 2]

    pb = init_patches.shape[-1]
    center = (pb - 1) / 2.0
    sample = uv_i - init_uvs[:, None, :] + center  # [K, P², 2]
    u = torch.clamp(sample[..., 0], 0.0, pb - 1.001)
    v = torch.clamp(sample[..., 1], 0.0, pb - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du, dv = u - u0, v - v0
    # the tap's index, exact in f32 (< pb²); a NaN position (an
    # inactive slot's: a non-finite pixel, or its zero init pose seeing
    # the point on its own plane) reads tap 0 with NaN weights, so its
    # row is NaN and no index leaves the patch
    idx = torch.nan_to_num(v0 * pb + u0, nan=0.0).to(torch.int64)  # [K, P²]
    flat = init_patches.reshape(k, pb * pb)
    tap = lambda off: torch.gather(flat, 1, idx + off)  # noqa: E731
    # the reference's weights times taps, summed in tap-index order
    vals = (((1 - du) * (1 - dv)) * tap(0) + (du * (1 - dv)) * tap(1)
            + ((1 - du) * dv) * tap(pb) + (du * dv) * tap(pb + 1))
    vals = vals - torch.mean(vals, dim=-1, keepdim=True)
    return vals / torch.clamp(torch.linalg.vector_norm(vals, dim=-1,
                                                       keepdim=True), min=1e-8)


def predict_patch_appearance(cam: Camera, init_patch, init_uv, init_cam,
                             cur_cam, lm_w, h_pred,
                             patch: int = 11) -> torch.Tensor:
    """[patch²] predicted appearance of one feature (predict_patches of a
    batch of one)."""
    return predict_patches(cam, init_patch[None], init_uv[None],
                           init_cam[None], cur_cam, lm_w[None], h_pred[None],
                           patch=patch)[0]
