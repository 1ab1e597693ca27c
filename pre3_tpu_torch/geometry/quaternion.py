"""Quaternion algebra (Hamilton convention, scalar-first [w, x, y, z]).

Port of ``pre3_tpu/geometry/quaternion.py``: ``q2r(q) @ rb`` maps a
body-frame vector to the world frame. Every function acts on the trailing
axis, so leading batch axes broadcast.
"""

from __future__ import annotations

import torch


def qprod(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate [w, -x, -y, -z]."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize to unit quaternion."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def q2r(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → 3×3 rotation matrix, body→world."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    ab, ac, ad = 2 * a * b, 2 * a * c, 2 * a * d
    bc, bd, cd = 2 * b * c, 2 * b * d, 2 * c * d
    row0 = torch.stack([aa + bb - cc - dd, bc - ad, bd + ac], dim=-1)
    row1 = torch.stack([bc + ad, aa - bb + cc - dd, cd - ab], dim=-1)
    row2 = torch.stack([bd - ac, cd + ab, aa - bb - cc + dd], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def qrotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion q without forming R:
    v' = v + 2·qv × (qv × v + w·v)."""
    w = q[..., :1]
    qv = q[..., 1:]
    # linalg.cross wants equal ranks (jnp.cross broadcasts them)
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def r2q(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion.

    Branch-free Shepperd selection: all four candidate constructions are
    computed and the one with the largest pivot is kept, in the
    reference's pivot order (w, then x, then y, else z).
    """
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-20))

    sw = safe_sqrt(1.0 + tr)  # 2w
    qw0 = torch.stack(
        [0.5 * sw, (m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
         (m10 - m01) / (2 * sw)], dim=-1)

    sx = safe_sqrt(1.0 + m00 - m11 - m22)
    qx0 = torch.stack(
        [(m21 - m12) / (2 * sx), 0.5 * sx, (m01 + m10) / (2 * sx),
         (m02 + m20) / (2 * sx)], dim=-1)

    sy = safe_sqrt(1.0 - m00 + m11 - m22)
    qy0 = torch.stack(
        [(m02 - m20) / (2 * sy), (m01 + m10) / (2 * sy), 0.5 * sy,
         (m12 + m21) / (2 * sy)], dim=-1)

    sz = safe_sqrt(1.0 - m00 - m11 + m22)
    qz0 = torch.stack(
        [(m10 - m01) / (2 * sz), (m02 + m20) / (2 * sz),
         (m12 + m21) / (2 * sz), 0.5 * sz], dim=-1)

    use_w = (tr > m00) & (tr > m11) & (tr > m22)
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)

    q = torch.where(use_w[..., None], qw0,
                    torch.where(use_x[..., None], qx0,
                                torch.where(use_y[..., None], qy0, qz0)))
    # Canonical sign: w >= 0.
    q = torch.where(q[..., :1] < 0, -q, q)
    return qnormalize(q)


def v2q(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (axis·angle) → quaternion, Taylor-safe near zero."""
    angle2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = angle2 < 1e-12
    angle2_safe = torch.where(small, torch.ones_like(angle2), angle2)
    angle = torch.sqrt(angle2_safe)
    # sin(a/2)/a with series fallback: 1/2 - a^2/48
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(angle / 2.0) / angle)
    # [..., 1]-shaped, not 0-d: under torch.func.jacfwd a 0-d tensor op
    # with a Python float gives a float64 tangent
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(angle / 2.0))
    return torch.cat([w, k * v], dim=-1)


def q2v(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → rotation vector, Taylor-safe."""
    q = torch.where(q[..., :1] < 0, -q, q)  # w >= 0 → angle in [0, pi]
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    s2 = torch.sum(q[..., 1:] * q[..., 1:], dim=-1)
    s = torch.sqrt(torch.clamp(s2, min=1e-24))
    angle = 2.0 * torch.atan2(s, w)
    k = torch.where(s2 < 1e-12, 2.0 / torch.clamp(w, min=1e-12), angle / s)
    return k[..., None] * q[..., 1:]


def e2q(e: torch.Tensor) -> torch.Tensor:
    """Euler angles [roll(x), pitch(y), yaw(z)] → quaternion, ZYX order
    (q = qz ⊗ qy ⊗ qx)."""
    half = 0.5 * e
    cr, cp, cy = torch.cos(half[..., 0]), torch.cos(half[..., 1]), torch.cos(half[..., 2])
    sr, sp, sy = torch.sin(half[..., 0]), torch.sin(half[..., 1]), torch.sin(half[..., 2])
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def q2e(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → Euler [roll, pitch, yaw]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)
