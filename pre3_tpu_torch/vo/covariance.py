"""Pose-shift covariance of the RANSAC rigid-motion estimate.

Port of ``pre3_tpu/vo/covariance.py``: the implicit-function-theorem form

  θ* = argmin E(θ, F)  with E the weighted alignment cost,
  Σ_θ = A⁻¹ (Σᵢ Bᵢ Σ_pᵢ Bᵢᵀ) A⁻ᵀ,  A = ∂²E/∂θ², Bᵢ = ∂²E/∂θ∂pᵢ

with the SR4000 sensor noise model in spherical coordinates (range σ_r =
1 cm, angular σ_a = 0.24°). θ is the 6-vector [dt, dω] perturbation of
the fitted (R, t); Σ_θ is the covariance of the VO increment that feeds
the EKF prediction.

``vo_covariance_torch`` takes the derivatives from ``torch.func``: the
CPU path and the oracle of ``ops/vo_covariance.py``, whose
``vo_covariance`` is the entry point (kernel K4 on CUDA tensors).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd

from pre3_tpu_torch.geometry.quaternion import qrotate, v2q

SIGMA_RANGE = 0.01  # m
SIGMA_ANG = float(np.float32(0.24 * math.pi / 180.0))  # rad, f32 as the reference
DAMPING = 1e-6  # the ridge on A (rank-deficient with too few inliers)


def sr4000_point_covariance(p: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] Cartesian covariance of an SR4000 3D point: σ_r along
    the ray, r·σ_a across it."""
    r = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    ray = p / torch.clamp(r, min=1e-9)
    var_t = (r[..., 0] * SIGMA_ANG) ** 2
    var_r = SIGMA_RANGE**2
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    rr = ray[..., :, None] * ray[..., None, :]
    return var_r * rr + var_t[..., None, None] * (eye - rr)


def _cost(theta, r, t, p1, p2, w):
    """Weighted alignment cost at the pose perturbation θ = [dt, dω]."""
    dq = v2q(theta[3:])
    pred = qrotate(dq[None], torch.einsum("ij,nj->ni", r, p2)) + t + theta[:3]
    resid = p1 - pred
    # the 0.5 scales the [N] terms: a 0-d op with a Python float would
    # give a float64 tangent under torch.func.hessian
    return torch.sum(0.5 * w * torch.sum(resid * resid, dim=-1))


def vo_covariance_torch(
    r: torch.Tensor,  # [3, 3] fitted rotation
    t: torch.Tensor,  # [3] fitted translation
    p1: torch.Tensor,  # [N, 3] frame-1 points
    p2: torch.Tensor,  # [N, 3] frame-2 points
    w: torch.Tensor,  # [N] inlier weights
) -> torch.Tensor:
    """[6, 6] covariance of the VO increment [dt, dω], the derivatives
    by ``torch.func``."""
    zero = torch.zeros(6, dtype=p1.dtype, device=p1.device)
    a = hessian(_cost, argnums=0)(zero, r, t, p1, p2, w)  # [6, 6]
    # B_i = ∂²E/∂θ∂p1_i and ∂²E/∂θ∂p2_i as Jacobians of the gradient
    # with respect to the point arrays: [6, N, 3]
    grad_theta = grad(_cost, argnums=0)
    b1 = jacfwd(lambda pp: grad_theta(zero, r, t, pp, p2, w))(p1)
    b2 = jacfwd(lambda pp: grad_theta(zero, r, t, p1, pp, w))(p2)
    s1 = sr4000_point_covariance(p1)  # [N, 3, 3]
    s2 = sr4000_point_covariance(p2)
    mid = (torch.einsum("anj,njk,bnk->ab", b1, s1, b1)
           + torch.einsum("anj,njk,bnk->ab", b2, s2, b2))
    # damped inverse of A (rank-deficient when too few inliers); the _ex
    # form leaves the singularity flag on the card instead of syncing
    a_reg = a + DAMPING * torch.eye(6, dtype=a.dtype, device=a.device)
    a_inv, _ = torch.linalg.inv_ex(a_reg)
    cov = a_inv @ mid @ a_inv.T
    return 0.5 * (cov + cov.T)
