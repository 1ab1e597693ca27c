"""Closed-form batched 3×3 SVD for rigid alignment.

Port of ``pre3_tpu/ops/svd3.py``: eigenvalues of AᵀA by the trigonometric
solution of the characteristic cubic, eigenvectors by cross products of
pivot rows, U = A V S⁻¹ with orthogonal completion for rank-deficient
inputs. All elementwise and branch-free, so it batches over thousands of
RANSAC hypotheses without a data-dependent iteration. Every epsilon is the
reference's: they decide the degenerate branches.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _basis(like: torch.Tensor, axis: int) -> torch.Tensor:
    """Unit vector e_axis with the shape, dtype and device of ``like``.
    (``fill_`` passes 1.0 as a kernel argument; ``e[..., axis] = 1.0``
    would copy it from the host and wait for the device.)"""
    e = torch.zeros_like(like)
    e[..., axis].fill_(1.0)
    return e


def sym3_eigvals(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], descending, via the
    trigonometric closed form (stable for repeated roots)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (
        b00 * b00 + b11 * b11 + b22 * b22
        + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    )
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    # det(B)/2 with B = (A - qI)
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = detb / (2.0 * p * p * p)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e1, e2, e3], dim=-1)


def _eigvec(a: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric [..., 3, 3] for eigenvalue lam via the
    largest cross product of rows of (A − λI) (branch-free pivoting)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = a - lam[..., None, None] * eye
    r0, r1, r2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None], c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    nbest = torch.maximum(n01, torch.maximum(n02, n12))
    # Degenerate (repeated eigenvalue / zero matrix): fall back to e_x; the
    # caller re-orthogonalizes, so any unit vector is acceptable there.
    ok = nbest > _EPS
    v = torch.where(ok[..., None], best, _basis(best, 0))
    return v / _norm(v)


def svd3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form SVD of [..., 3, 3]: returns (u, s, vt) with
    a = u @ diag(s) @ vt, s descending, u/v orthogonal (possibly improper —
    the same contract as torch.linalg.svd)."""
    # scale-normalize so the internal epsilons are relative, not absolute
    anorm = torch.sqrt(
        torch.clamp(torch.sum(a * a, dim=(-2, -1), keepdim=True), min=_EPS)
    )
    scale = anorm[..., 0, 0]
    a = a / anorm
    ata = torch.einsum("...ji,...jk->...ik", a, a)
    lam = sym3_eigvals(ata)
    s = torch.sqrt(torch.clamp(lam, min=0.0))

    v0 = _eigvec(ata, lam[..., 0])
    v1 = _eigvec(ata, lam[..., 1])
    # enforce orthogonality (repeated eigenvalues make separate cross
    # products unreliable): Gram-Schmidt v1 ⊥ v0, v2 = v0 × v1
    v1 = v1 - torch.sum(v1 * v0, dim=-1, keepdim=True) * v0
    n1 = _norm(v1)
    # if v1 collapsed (λ0 ≈ λ1), recover a vector in the λ1-eigenplane:
    # the dominant row of B1 = A − λ1 I is ⊥ to it, so
    # v1 = normalize(r_max × v0) stays in the eigenplane and ⊥ v0.
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b1 = ata - lam[..., 1:2, None] * eye
    row_norms = torch.sum(b1 * b1, dim=-1)  # [..., 3]
    rmax_idx = torch.argmax(row_norms, dim=-1)
    r_max = torch.gather(
        b1, -2, rmax_idx[..., None, None].expand(*rmax_idx.shape, 1, 3)
    )[..., 0, :]
    alt = _cross(r_max, v0)
    alt_n = _norm(alt)
    # triple eigenvalue (A ∝ I): any orthogonal completion works
    alt2 = _cross(v0, _basis(v0, 0))
    alt3 = _cross(v0, _basis(v0, 1))
    alt2 = torch.where(_norm(alt2) > 1e-6, alt2, alt3)
    alt = torch.where(
        alt_n > 1e-6 * torch.sqrt(torch.amax(row_norms, dim=-1))[..., None],
        alt, alt2,
    )
    alt = alt / _norm(alt)
    v1 = torch.where(n1 > 1e-4, v1 / torch.clamp(n1, min=_EPS), alt)
    v2 = _cross(v0, v1)
    v = torch.stack([v0, v1, v2], dim=-1)  # columns

    # U columns: u_i = A v_i / s_i, with orthogonal completion when s_i ≈ 0
    av = torch.einsum("...ij,...jk->...ik", a, v)
    u0 = av[..., 0]
    u0n = _norm(u0)
    u0 = torch.where(u0n > 1e-9, u0 / torch.clamp(u0n, min=_EPS),
                     _basis(u0, 0))
    u1 = av[..., 1]
    u1 = u1 - torch.sum(u1 * u0, dim=-1, keepdim=True) * u0
    u1n = _norm(u1)
    altu = _cross(u0, _basis(u0, 0))
    altu_n = _norm(altu)
    altu2 = _cross(u0, _basis(u0, 1))
    altu = torch.where(altu_n > 1e-6, altu, altu2)
    altu = altu / _norm(altu)
    u1 = torch.where(u1n > 1e-9, u1 / torch.clamp(u1n, min=_EPS), altu)
    u2raw = av[..., 2]
    u2raw = (
        u2raw
        - torch.sum(u2raw * u0, dim=-1, keepdim=True) * u0
        - torch.sum(u2raw * u1, dim=-1, keepdim=True) * u1
    )
    u2n = _norm(u2raw)
    u2 = torch.where(
        u2n > 1e-9, u2raw / torch.clamp(u2n, min=_EPS), _cross(u0, u1)
    )
    u = torch.stack([u0, u1, u2], dim=-1)
    return u, s * scale[..., None], v.transpose(-1, -2)
