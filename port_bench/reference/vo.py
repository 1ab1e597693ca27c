"""Frame-to-frame visual odometry as the configuration defines it,
written plainly: descriptor matching with the ratio test, RANSAC over
four-point Kabsch hypotheses drawn by Gumbel top-k, the support count
of each hypothesis (K1's job in the program), a range-weighted refit on
the winner's inliers, and the increment's covariance by the implicit
function theorem under the SR4000 noise model."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import hessian, jacrev

from port_bench.reference.geometry import matrix_quaternion

BIG = 1e30
SIGMA_RANGE = 0.01  # m
SIGMA_ANGLE = float(np.float32(0.24 * math.pi / 180.0))  # rad


class Match(NamedTuple):
    index: torch.Tensor  # [N1] best column
    accepted: torch.Tensor  # [N1]


def match(d1, d2, valid1, valid2, ratio: float) -> Match:
    """Nearest descriptor of d2 for each row of d1 by squared distance
    (columns outside ``valid2`` at 1e30), accepted where best·ratio <
    second, the best under 1e30, and the row in ``valid1`` (K2's job in
    the program)."""
    dist = ((d1[:, None, :] - d2[None, :, :]) ** 2).sum(-1)
    dist = torch.where(valid2[None, :], dist, BIG)
    two = torch.sort(dist, dim=-1, stable=True)
    best, second = two.values[:, 0], two.values[:, 1]
    ok = (best * ratio < second) & (best < BIG) & valid1
    return Match(two.indices[:, 0], ok)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The program's standard Gumbel draw −log(−log u), u ~ U[0, 1) in
    float32 from ``generator`` (held above the smallest normal)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to the lower
    index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class Fit(NamedTuple):
    r: torch.Tensor
    t: torch.Tensor
    ok: torch.Tensor


def kabsch(p, q, w) -> Fit:
    """Weighted least squares p ≈ R·q + t by the SVD of the weighted
    cross-covariance; ``ok`` where its second singular value exceeds a
    hundredth of the first and three weights or more are positive."""
    wn = w / w.sum(-1, keepdim=True).clamp(min=1e-12)
    cp = (wn[..., None] * p).sum(-2)
    cq = (wn[..., None] * q).sum(-2)
    h = ((q - cq[..., None, :]) * wn[..., None]).transpose(-1, -2) @ (
        p - cp[..., None, :])
    u, s, vh = torch.linalg.svd(h)
    v = vh.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(v @ u.transpose(-1, -2)))
    d = torch.diag_embed(torch.stack(
        [torch.ones_like(sign), torch.ones_like(sign), sign], -1))
    r = v @ d @ u.transpose(-1, -2)
    t = cp - (r @ cq[..., None])[..., 0]
    ok = (s[..., 1] > 0.01 * s[..., 0].clamp(min=1e-20)) & (
        (w > 0).sum(-1) >= 3)
    return Fit(r, t, ok)


def residual2(r, t, p1, p2):
    """‖R·p2 + t − p1‖² of every hypothesis and pair: [B, N]."""
    pred = torch.einsum("bij,nj->bni", r, p2) + t[:, None, :]
    return ((pred - p1[None]) ** 2).sum(-1)


def point_covariance(p):
    """SR4000 point covariance: σ_r² along the ray, (r·σ_a)² across."""
    r = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    u = p / r.clamp(min=1e-9)
    uu = u[..., :, None] * u[..., None, :]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    return SIGMA_RANGE ** 2 * uu + ((r[..., 0] * SIGMA_ANGLE) ** 2)[
        ..., None, None] * (eye - uu)


def increment_covariance(r, t, p1, p2, w):
    """[6, 6] covariance of the increment θ = [dt, dω] about the fit,
    A⁻¹(Σ B Σ_p Bᵀ)A⁻ᵀ with A = ∂²E/∂θ², B = ∂²E/∂θ∂p, A damped by 1e-6·I,
    for E = Σ w/2 ‖p1 − (exp(dω)·R·p2 + t + dt)‖². Only derivatives up
    to the second at θ = 0 enter, so exp(dω)·a is taken to second order:
    a + dω×a + dω×(dω×a)/2."""

    def cost(theta, a1, a2):
        a = a2 @ r.T
        wv = theta[3:].expand_as(a)
        ra = a + torch.linalg.cross(wv, a, dim=-1) + 0.5 * torch.linalg.cross(
            wv, torch.linalg.cross(wv, a, dim=-1), dim=-1)
        res = a1 - (ra + t + theta[:3])
        return (0.5 * w * (res * res).sum(-1)).sum()

    zero = torch.zeros(6, dtype=p1.dtype, device=p1.device)
    a = hessian(cost)(zero, p1, p2)
    grad_theta = jacrev(cost)
    b1 = jacrev(grad_theta, argnums=1)(zero, p1, p2)  # [6, N, 3]
    b2 = jacrev(grad_theta, argnums=2)(zero, p1, p2)
    mid = (torch.einsum("anj,njk,bnk->ab", b1, point_covariance(p1), b1)
           + torch.einsum("anj,njk,bnk->ab", b2, point_covariance(p2), b2))
    a_inv = torch.linalg.inv(a + 1e-6 * torch.eye(6, dtype=a.dtype,
                                                   device=a.device))
    cov = a_inv @ mid @ a_inv.T
    return 0.5 * (cov + cov.T)


class Odometry(NamedTuple):
    t: torch.Tensor  # [3]
    q: torch.Tensor  # [4]
    ok: torch.Tensor  # []
    cov: torch.Tensor  # [6, 6]


def odometry(f1, f2, g: torch.Tensor, ratio: float = 1.3,
             min_inliers: int = 8) -> Odometry:
    """The motion of camera 2 in camera 1 (p1 = R·p2 + t) from two
    feature sets; ``g`` [B, N1] is the step's Gumbel draw."""
    m = match(f1.desc, f2.desc, f1.valid, f2.valid, ratio)
    p1, p2 = f1.xyz, f2.xyz[m.index]
    valid = m.accepted & f1.valid & f2.valid[m.index]
    near2 = torch.where(valid, (p2 * p2).sum(-1), math.inf).min()
    thr = 0.001 * torch.sqrt(near2)
    logits = torch.where(valid, 0.0, -math.inf).to(g.dtype)
    idx = topk_stable(logits[None] + g, 4)  # [B, 4]
    ones = torch.ones(idx.shape, dtype=p1.dtype, device=p1.device)
    hyp = kabsch(p1[idx], p2[idx], ones)
    res2 = residual2(hyp.r, hyp.t, p1, p2)
    inl = (res2 < thr) & valid
    support = inl.sum(-1)
    err = torch.where(inl, res2, 0.0).sum(-1) / support.clamp(min=1)
    score = torch.where(hyp.ok, support - err / (err + 1), -1.0)
    best = int(torch.argmax(score))
    w = ((res2[best] < thr) & valid).to(p1.dtype) / (p2 * p2).sum(-1).clamp(
        min=0.25)
    fit = kabsch(p1, p2, w)
    res2 = residual2(fit.r[None], fit.t[None], p1, p2)[0]
    inl = (res2 < thr) & valid
    ok = fit.ok & (inl.sum() >= min_inliers)
    cov = increment_covariance(fit.r, fit.t, p1, p2, inl.to(p1.dtype))
    return Odometry(fit.t, matrix_quaternion(fit.r), ok, cov)
