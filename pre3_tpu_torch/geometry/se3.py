"""SE(3) poses as (translation, quaternion) pairs.

Port of ``pre3_tpu/geometry/se3.py``. A pose (t, q) maps body-frame points
to the world frame: x_w = R(q) x_b + t. All ops take leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.geometry.quaternion import (
    q2r, q2v, qconj, qnormalize, qprod, qrotate, r2q,
)


class Pose(NamedTuple):
    """World-from-body rigid transform."""

    t: torch.Tensor  # [..., 3] translation
    q: torch.Tensor  # [..., 4] unit quaternion, scalar-first


def pose_identity(batch_shape=(), dtype=torch.float32, device=None) -> Pose:
    t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0].fill_(1.0)
    return Pose(t=t, q=q)


def pose_compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a (x → a(b(x)))."""
    return Pose(t=a.t + qrotate(a.q, b.t), q=qnormalize(qprod(a.q, b.q)))


def pose_inverse(a: Pose) -> Pose:
    qi = qconj(a.q)
    return Pose(t=-qrotate(qi, a.t), q=qi)


def pose_apply(a: Pose, x: torch.Tensor) -> torch.Tensor:
    """Transform points [..., 3] by the pose."""
    return qrotate(a.q, x) + a.t


def pose_delta(a: Pose, b: Pose) -> Pose:
    """Relative pose a⁻¹ ∘ b (the motion taking frame a to frame b)."""
    return pose_compose(pose_inverse(a), b)


def pose_to_matrix(a: Pose) -> torch.Tensor:
    """Pose → 4×4 homogeneous matrix."""
    r = q2r(a.q)
    top = torch.cat([r, a.t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def pose_from_matrix(h: torch.Tensor) -> Pose:
    """4×4 homogeneous matrix → Pose."""
    return Pose(t=h[..., :3, 3], q=r2q(h[..., :3, :3]))


def pose_log(a: Pose) -> torch.Tensor:
    """Pose → 6-vector [t, rotation-vector] (decoupled log)."""
    return torch.cat([a.t, q2v(a.q)], dim=-1)
