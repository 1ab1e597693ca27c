"""Rigid-motion estimation from matched 3D point sets.

Port of ``pre3_tpu/vo/rigid.py``: weighted Kabsch/Arun through the
closed-form 3×3 SVD, and Horn's quaternion method. Both are batched over
leading axes and take per-point weights, so fixed-capacity masked point
sets flow straight through.

Convention: given point sets P (frame 1) and Q (frame 2), solve
P ≈ R·Q + t — the transform taking frame-2 coordinates into frame 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.geometry.quaternion import q2r
from pre3_tpu_torch.ops.svd3 import svd3


class RigidFit(NamedTuple):
    r: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]
    ok: torch.Tensor  # [...] bool — well-conditioned solution
    rmse: torch.Tensor  # [...] weighted RMS residual


def _weighted_stats(p, q, w):
    wsum = torch.sum(w, dim=-1, keepdim=True)
    wn = w / torch.clamp(wsum, min=1e-12)
    cp = torch.sum(p * wn[..., None], dim=-2)
    cq = torch.sum(q * wn[..., None], dim=-2)
    pc = p - cp[..., None, :]
    qc = q - cq[..., None, :]
    # cross-covariance H = Σ w·qc·pcᵀ  (maps frame-2 deviations to frame-1)
    h = torch.einsum("...ni,...nj->...ij", qc * wn[..., None], pc)
    return cp, cq, pc, qc, h


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] in closed form (no batched LU)."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _residual_rmse(p, q, w, r, t):
    resid = p - (torch.einsum("...ij,...nj->...ni", r, q) + t[..., None, :])
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    return torch.sqrt(
        torch.sum(w * torch.sum(resid * resid, dim=-1), dim=-1) / wsum
    )


def kabsch(
    p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None,
    cond_eps: float = 1e-2,
) -> RigidFit:
    """Weighted Kabsch/Arun: least-squares R, t minimizing Σw‖p − (Rq+t)‖².

    p, q: [..., N, 3]; w: [..., N] nonnegative weights (mask). Reflection is
    corrected by flipping the smallest singular direction. ``ok`` is False
    when the point set is degenerate (rank < 2 ⇒ rotation unobservable) or
    fewer than 3 weights are positive.
    """
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    cp, cq, pc, qc, h = _weighted_stats(p, q, w)
    u, s, vt = svd3(h)
    # maximize tr(R H) with H = Σ qc pcᵀ ⇒ R = V D Uᵀ, D fixing det(R) = +1
    det = _det3(torch.einsum("...ij,...kj->...ik", vt, u))  # det(VUᵀ)
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, det], dim=-1)  # [..., 3]
    r = torch.einsum("...ji,...j,...jk->...ik", vt, d, u.transpose(-1, -2))
    t = cp - torch.einsum("...ij,...j->...i", r, cq)
    rmse = _residual_rmse(p, q, w, r, t)
    # Conditioning: need at least rank 2 (two non-tiny singular values).
    ok = (s[..., 1] > cond_eps * torch.clamp(s[..., 0], min=1e-20)) & (
        torch.sum(w > 0, dim=-1) >= 3
    )
    return RigidFit(r=r, t=t, ok=ok, rmse=rmse)


def horn_quaternion(
    p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None
) -> RigidFit:
    """Horn's absolute-orientation quaternion method: the rotation is the
    dominant eigenvector of the 4×4 N matrix built from the
    cross-covariance. It never returns a reflection."""
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    cp, cq, pc, qc, h = _weighted_stats(p, q, w)
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    tr = sxx + syy + szz
    row0 = torch.stack([tr, syz - szy, szx - sxz, sxy - syx], dim=-1)
    row1 = torch.stack(
        [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], dim=-1
    )
    row2 = torch.stack(
        [szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], dim=-1
    )
    row3 = torch.stack(
        [sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], dim=-1
    )
    n = torch.stack([row0, row1, row2, row3], dim=-2)
    evals, evecs = torch.linalg.eigh(n)
    qrot = evecs[..., :, -1]  # dominant eigenvector
    qrot = torch.where(qrot[..., :1] < 0, -qrot, qrot)
    r = q2r(qrot)
    t = cp - torch.einsum("...ij,...j->...i", r, cq)
    rmse = _residual_rmse(p, q, w, r, t)
    gap = evals[..., -1] - evals[..., -2]
    ok = (gap > 1e-9) & (torch.sum(w > 0, dim=-1) >= 3)
    return RigidFit(r=r, t=t, ok=ok, rmse=rmse)
