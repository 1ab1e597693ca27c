"""Camera, rotations and landmark parameterisations, written out as
textbook formulas (Hamilton quaternions [w, x, y, z], the SR4000's
radial distortion and Civera's inverse depth).

Every function broadcasts over leading axes and works in any floating
dtype; the reference runs them in float64."""

from __future__ import annotations

import numpy as np
import torch

# SR4000 calibration (initialize_cam.m), as float32 values: the stored
# intrinsics are float32 numbers, whatever precision computes with them.
_F32 = lambda v: float(np.float32(v))  # noqa: E731
FOCAL, CX, CY = _F32(250.57731), _F32(91.69), _F32(72.27)
KD1, KD2 = _F32(-0.84656), _F32(0.53701)
ROWS, COLS = 144, 176


def hamilton(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Quaternion product a ⊗ b."""
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    w = aw * bw - (av * bv).sum(-1, keepdim=True)
    v = aw * bv + bw * av + torch.linalg.cross(av, bv, dim=-1)
    return torch.cat([w, v], -1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v rotated by q: v + w·t + q_v × t with t = 2·q_v × v (the vector
    form of q ⊗ [0, v] ⊗ q*)."""
    w, qv = q[..., :1], q[..., 1:]
    t = 2 * torch.linalg.cross(qv.expand_as(v), v, dim=-1)
    return v + w * t + torch.linalg.cross(qv.expand_as(t), t, dim=-1)


def unrotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v rotated by q's conjugate (world → camera for q = q_wc)."""
    return rotate(torch.cat([q[..., :1], -q[..., 1:]], -1), v)


def normalised(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(
        min=1e-12)


def axis_angle_quaternion(v: torch.Tensor) -> torch.Tensor:
    """Quaternion of the rotation vector v (angle |v| about v/|v|); the
    series 1 − θ²/8, 1/2 − θ²/48 below θ² = 1e-12."""
    th2 = (v * v).sum(-1, keepdim=True)
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    c = torch.where(small, 1 - th2 / 8, torch.cos(th / 2))
    s = torch.where(small, 0.5 - th2 / 48, torch.sin(th / 2) / th)
    return torch.cat([c, s * v], -1)


def quaternion_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector of q, taken with w ≥ 0 (angle in [0, π])."""
    q = torch.where(q[..., :1] < 0, -q, q)
    vn2 = (q[..., 1:] ** 2).sum(-1)
    vn = torch.sqrt(vn2.clamp(min=1e-24))
    angle = 2 * torch.atan2(vn, q[..., 0].clamp(-1, 1))
    scale = torch.where(vn2 < 1e-12, 2 / q[..., 0].clamp(min=1e-12),
                        angle / vn)
    return scale[..., None] * q[..., 1:]


def matrix_quaternion(r: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w ≥ 0) of a rotation matrix: the largest of
    4w², 4x², 4y², 4z² sets the pivot (the trace first, on ties)."""
    m = r
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = []
    for k in range(4):
        if k == 0:
            s = torch.sqrt((1 + tr).clamp(min=1e-20)) * 2
            q = [s / 4, (m[..., 2, 1] - m[..., 1, 2]) / s,
                 (m[..., 0, 2] - m[..., 2, 0]) / s,
                 (m[..., 1, 0] - m[..., 0, 1]) / s]
        else:
            i = k - 1
            j, l = (i + 1) % 3, (i + 2) % 3
            s = torch.sqrt((1 + m[..., i, i] - m[..., j, j]
                            - m[..., l, l]).clamp(min=1e-20)) * 2
            q = [None] * 4
            q[0] = (m[..., l, j] - m[..., j, l]) / s
            q[1 + i] = s / 4
            q[1 + j] = (m[..., j, i] + m[..., i, j]) / s
            q[1 + l] = (m[..., l, i] + m[..., i, l]) / s
        cands.append(torch.stack(q, -1))
    d = torch.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)
    use_w = (d[..., 0] > d[..., 1]) & (d[..., 0] > d[..., 2]) & (
        d[..., 0] > d[..., 3])
    use_x = ~use_w & (d[..., 1] >= d[..., 2]) & (d[..., 1] >= d[..., 3])
    use_y = ~use_w & ~use_x & (d[..., 2] >= d[..., 3])
    q = torch.where(use_w[..., None], cands[0], torch.where(
        use_x[..., None], cands[1], torch.where(use_y[..., None], cands[2],
                                                cands[3])))
    return normalised(torch.where(q[..., :1] < 0, -q, q))


def euler_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Quaternion of Euler angles [roll, pitch, yaw], q = q_z ⊗ q_y ⊗ q_x."""
    zero = torch.zeros_like(e[..., 0])

    def about(axis, angle):
        parts = [torch.cos(angle / 2), zero, zero, zero]
        parts[1 + axis] = torch.sin(angle / 2)
        return torch.stack(parts, -1)

    return hamilton(hamilton(about(2, e[..., 2]), about(1, e[..., 1])),
                    about(0, e[..., 0]))


# --- camera ----------------------------------------------------------------


def _centred(uv: torch.Tensor) -> torch.Tensor:
    """Pixel → normalised image coordinates, (u − cx, v − cy)/f."""
    return torch.cat([uv[..., 0:1] - CX, uv[..., 1:2] - CY], -1) / FOCAL


def _pixel_of(n: torch.Tensor) -> torch.Tensor:
    """Normalised image coordinates → pixel."""
    return torch.cat([CX + FOCAL * n[..., 0:1], CY + FOCAL * n[..., 1:2]], -1)


def distort(uv: torch.Tensor) -> torch.Tensor:
    """Undistorted → distorted pixel: x_d = x_u·(1 + k1·r² + k2·r⁴)."""
    n = _centred(uv)
    r2 = (n * n).sum(-1, keepdim=True)
    return _pixel_of(n * (1 + KD1 * r2 + KD2 * r2 * r2))


def undistort(uvd: torch.Tensor) -> torch.Tensor:
    """Distorted → undistorted pixel: r_u from r_u·(1 + k1·r_u² + k2·r_u⁴)
    = r_d by ten Newton steps from r_d / D(r_d), as the camera model
    defines it."""
    nd = _centred(uvd)
    rd = torch.linalg.vector_norm(nd, dim=-1, keepdim=True)
    ru = rd / (1 + KD1 * rd ** 2 + KD2 * rd ** 4)
    for _ in range(10):
        g = ru * (1 + KD1 * ru ** 2 + KD2 * ru ** 4) - rd
        ru = ru - g / (1 + 3 * KD1 * ru ** 2 + 5 * KD2 * ru ** 4)
    dist = 1 + KD1 * ru ** 2 + KD2 * ru ** 4
    return _pixel_of(nd / torch.where(dist == 0, torch.ones_like(dist), dist))


def pixel(p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame point → distorted pixel (|z| < 1e-9 held at 1e-9)."""
    z = p_cam[..., 2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return distort(_pixel_of(p_cam[..., :2] / z))


# --- inverse depth (Civera) ------------------------------------------------


def ray(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """m(θ, φ) = [cos φ sin θ, −sin φ, cos φ cos θ]."""
    return torch.stack([torch.cos(phi) * torch.sin(theta), -torch.sin(phi),
                        torch.cos(phi) * torch.cos(theta)], -1)


def landmark_from_pixel(uvd: torch.Tensor, t_wc: torch.Tensor,
                        q_wc: torch.Tensor, rho: torch.Tensor):
    """[x0, y0, z0, θ, φ, ρ] of a distorted pixel seen from (t_wc, q_wc)."""
    n_cam = _centred(undistort(uvd))
    d = rotate(q_wc, torch.cat([n_cam, torch.ones_like(n_cam[..., :1])], -1))
    theta = torch.atan2(d[..., 0], d[..., 2])
    phi = torch.atan2(-d[..., 1], torch.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2))
    return torch.cat([t_wc.expand(*theta.shape, 3), theta[..., None],
                      phi[..., None], rho[..., None]], -1)


def landmark_point(y: torch.Tensor) -> torch.Tensor:
    """World point of an inverse-depth landmark, y0 + m/ρ (ρ of 0 taken
    as +; |ρ| held at 1e-12 or more)."""
    rho = y[..., 5:6]
    sign = torch.where(rho < 0, -torch.ones_like(rho), torch.ones_like(rho))
    return y[..., :3] + ray(y[..., 3], y[..., 4]) * sign / rho.abs().clamp(
        min=1e-12)


def camera_direction(cam: torch.Tensor, lm: torch.Tensor,
                     inverse_depth: torch.Tensor) -> torch.Tensor:
    """Camera-frame direction of landmark slots: R_wcᵀ(ρ(y0 − t) + m) for
    inverse-depth slots, R_wcᵀ(p − t) for Cartesian ones."""
    t, q = cam[..., 0:3], cam[..., 3:7]
    d_id = lm[..., 5:6] * (lm[..., :3] - t) + ray(lm[..., 3], lm[..., 4])
    d_xyz = lm[..., :3] - t
    return unrotate(q, torch.where(inverse_depth[..., None], d_id, d_xyz))
