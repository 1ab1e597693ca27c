"""Inverse-depth landmark parameterization.

Port of ``pre3_tpu/geometry/inverse_depth.py``:

  landmark y = [x0, y0, z0, θ, φ, ρ]  — camera center at init (world),
  azimuth/elevation of the observation ray (world frame), inverse depth.

  ray        m(θ, φ) = [cosφ·sinθ, −sinφ, cosφ·cosθ]
  3D point   p = y0 + (1/ρ)·m(θ, φ)
  camera-frame direction for projection (scale-free, valid at ρ→0):
             hrl = R_cwᵀ · ( ρ·(y0 − t_wc) + m(θ, φ) )

Every function broadcasts over leading axes and works under ``torch.func``
transforms.
"""

from __future__ import annotations

import torch

from pre3_tpu_torch.geometry.camera import Camera, undistort
from pre3_tpu_torch.geometry.quaternion import qconj, qrotate


def ray_from_angles(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """m(θ, φ): unit world-frame observation ray."""
    cphi = torch.cos(phi)
    return torch.stack(
        [cphi * torch.sin(theta), -torch.sin(phi), cphi * torch.cos(theta)],
        dim=-1)


def angles_from_ray(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ray_from_angles."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    theta = torch.atan2(nx, nz)
    phi = torch.atan2(-ny, torch.sqrt(nx * nx + nz * nz))
    return theta, phi


def inverse_depth_point(
    cam: Camera, uvd: torch.Tensor, t_wc: torch.Tensor, q_wc: torch.Tensor,
    rho: torch.Tensor,
) -> torch.Tensor:
    """A 6-vector inverse-depth landmark from a distorted pixel
    observation and the current camera pose."""
    uv = undistort(cam, uvd)
    hx = (uv[..., 0:1] - cam.cx) / cam.f  # not 0-d: see geometry/camera.py
    hy = (uv[..., 1:2] - cam.cy) / cam.f
    h_lr = torch.cat([hx, hy, torch.ones_like(hx)], dim=-1)
    n = qrotate(q_wc, h_lr)  # ray in the world frame
    theta, phi = angles_from_ray(n)
    t_wc = t_wc.expand(*theta.shape, 3)
    return torch.cat(
        [t_wc, theta[..., None], phi[..., None], rho[..., None]], dim=-1)


def inverse_depth_to_cartesian(y: torch.Tensor) -> torch.Tensor:
    """[..., 6] inverse-depth landmark → [..., 3] world point."""
    rho = y[..., 5:6]
    m = ray_from_angles(y[..., 3], y[..., 4])
    return y[..., :3] + m / torch.clamp(torch.abs(rho), min=1e-12) * torch.sign(
        torch.where(rho == 0, 1.0, rho))


def inverse_depth_camera_ray(
    y: torch.Tensor, t_wc: torch.Tensor, q_wc: torch.Tensor
) -> torch.Tensor:
    """Scale-free camera-frame direction hrl of an inverse-depth landmark:
    R_cw(ρ·(y0 − t_wc) + m). Well defined as ρ→0."""
    rho = y[..., 5:6]
    m = ray_from_angles(y[..., 3], y[..., 4])
    v_w = rho * (y[..., :3] - t_wc) + m
    return qrotate(qconj(q_wc), v_w)


def linearity_index(
    y: torch.Tensor, sigma_rho: torch.Tensor, t_wc: torch.Tensor
) -> torch.Tensor:
    """Civera linearity index 4·σd·cosα/d of the inverse-depth → Cartesian
    conversion (convert when < 0.1). y [..., 6], sigma_rho [...], t_wc
    the current camera center."""
    rho = y[..., 5]
    std_d = sigma_rho / torch.clamp(rho * rho, min=1e-12)
    p = inverse_depth_to_cartesian(y)
    d1 = p - y[..., :3]  # from the init camera center
    d2 = p - t_wc  # from the current camera center
    n1 = torch.linalg.vector_norm(d1, dim=-1)
    n2 = torch.linalg.vector_norm(d2, dim=-1)
    cos_alpha = torch.sum(d1 * d2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
    return 4.0 * std_d * cos_alpha / torch.clamp(n2, min=1e-12)


def conversion_jacobian(y: torch.Tensor) -> torch.Tensor:
    """Closed-form Jacobian ∂p/∂y of the inverse-depth → Cartesian map,
    [..., 3, 6]."""
    theta, phi, rho = y[..., 3], y[..., 4], y[..., 5]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    m = ray_from_angles(theta, phi)
    dm_dtheta = torch.stack([cp * ct, torch.zeros_like(ct), -cp * st], dim=-1)
    dm_dphi = torch.stack([-sp * st, -cp, -sp * ct], dim=-1)
    inv_rho = 1.0 / rho
    eye = torch.eye(3, dtype=y.dtype, device=y.device)
    cols = [
        eye.expand(*y.shape[:-1], 3, 3),
        (inv_rho[..., None] * dm_dtheta)[..., None],
        (inv_rho[..., None] * dm_dphi)[..., None],
        (-(inv_rho * inv_rho)[..., None] * m)[..., None],
    ]
    return torch.cat(cols, dim=-1)
