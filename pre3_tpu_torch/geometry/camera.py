"""Pinhole camera with 2-parameter radial distortion (SR4000 calibration).

Port of ``pre3_tpu/geometry/camera.py``. The model:

  normalized undistorted  xu = (u - Cx)/f,  yu = (v - Cy)/f
  distortion factor       D  = 1 + k1·r² + k2·r⁴,  r² = xu² + yu²
  distorted pixel         ud = Cx + f·xu·D,  vd = Cy + f·yu·D

Undistortion inverts r_d = r_u·D(r_u) with a fixed 10-step Newton
iteration. The intrinsics are Python floats, not tensors: they enter every
kernel as arguments, and reading a 0-d CUDA tensor back into Python would
wait for the card. Every function broadcasts over leading axes and works
under ``torch.func`` transforms. Coordinates are sliced as [..., i:i+1],
never as 0-d: under ``torch.func.jacfwd`` an op between a 0-d tensor and
a Python float yields a float64 tangent (torch 2.x), and the Jacobians
must stay float32.

Pixel convention: u is the column coordinate (x, along width nCols=176)
and v the row coordinate (y, along height nRows=144).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    f: float  # focal length, pixels
    cx: float  # principal point x (column)
    cy: float  # principal point y (row)
    k1: float  # radial distortion
    k2: float
    n_rows: int  # image height
    n_cols: int  # image width


def sr4000_camera() -> Camera:
    """The reference's SR4000 calibration. The values are the float32
    roundings the JAX package stores, so both packages see the same
    intrinsics."""
    import numpy as np

    a = lambda x: float(np.float32(x))
    return Camera(f=a(250.57731), cx=a(91.69), cy=a(72.27), k1=a(-0.84656),
                  k2=a(0.53701), n_rows=144, n_cols=176)


def distort(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Undistorted pixel [..., 2] → distorted pixel."""
    xu = (uv[..., 0:1] - cam.cx) / cam.f
    yu = (uv[..., 1:2] - cam.cy) / cam.f
    r2 = xu * xu + yu * yu
    d = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    return torch.cat([cam.cx + cam.f * xu * d, cam.cy + cam.f * yu * d],
                     dim=-1)


def undistort(cam: Camera, uvd: torch.Tensor,
              newton_steps: int = 10) -> torch.Tensor:
    """Distorted pixel [..., 2] → undistorted pixel: Newton on
    r_u + k1·r_u³ + k2·r_u⁵ = r_d with a fixed step count."""
    xd = (uvd[..., 0:1] - cam.cx) / cam.f
    yd = (uvd[..., 1:2] - cam.cy) / cam.f
    rd = torch.sqrt(xd * xd + yd * yd)
    ru = rd / (1.0 + cam.k1 * rd * rd + cam.k2 * rd**4)
    for _ in range(newton_steps):
        f1 = ru + cam.k1 * ru**3 + cam.k2 * ru**5 - rd
        f1p = 1.0 + 3.0 * cam.k1 * ru * ru + 5.0 * cam.k2 * ru**4
        ru = ru - f1 / f1p
    d = 1.0 + cam.k1 * ru * ru + cam.k2 * ru**4
    safe_d = torch.where(d == 0, 1.0, d)
    return torch.cat(
        [cam.cx + cam.f * xd / safe_d, cam.cy + cam.f * yd / safe_d], dim=-1)


def project_point(cam: Camera, p_cam: torch.Tensor,
                  eps: float = 1e-9) -> torch.Tensor:
    """Camera-frame 3D point [..., 3] → *undistorted* pixel; z≈0 is
    guarded by eps (callers gate by visibility)."""
    z = p_cam[..., 2:3]
    safe_z = torch.where(torch.abs(z) < eps, eps, z)
    u = cam.cx + cam.f * p_cam[..., 0:1] / safe_z
    v = cam.cy + cam.f * p_cam[..., 1:2] / safe_z
    return torch.cat([u, v], dim=-1)


def project(cam: Camera, p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D point → distorted pixel (the measurement model h)."""
    return distort(cam, project_point(cam, p_cam))


def unproject(cam: Camera, uvd: torch.Tensor) -> torch.Tensor:
    """Distorted pixel [..., 2] → unit-z camera-frame ray [..., 3]."""
    uv = undistort(cam, uvd)
    x = (uv[..., 0] - cam.cx) / cam.f
    y = (uv[..., 1] - cam.cy) / cam.f
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def in_fov(
    cam: Camera,
    p_cam: torch.Tensor,
    uvd: torch.Tensor,
    half_fov_deg: float = 60.0,
    margin: float = 0.0,
) -> torch.Tensor:
    """Visibility gate: in front of the camera, within the FOV cone, and
    the distorted projection inside the image."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    rho = torch.sqrt(x * x + y * y)
    ang = torch.rad2deg(torch.atan2(rho, z))
    u, v = uvd[..., 0], uvd[..., 1]
    return (
        (z > 0)
        & (torch.abs(ang) < half_fov_deg)
        & (u > margin) & (u < cam.n_cols - 1 - margin)
        & (v > margin) & (v < cam.n_rows - 1 - margin)
    )
