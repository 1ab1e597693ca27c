"""Symmetric eigendecompositions that a CUDA graph can capture.

``torch.linalg.eigh`` checks its ``info`` on the host, so it waits for
the card and cannot be captured. The solvers here are plain tensor ops
with a fixed amount of work and no decision on the host; like ``eigh``
they return (eigenvalues ascending, orthonormal eigenvectors as columns):

* ``sym3_eigh`` [..., 3, 3]: the trigonometric closed form of
  ``ops/svd3.py`` picks the eigenvalue farthest from the middle one,
  whose eigenspace is a line; its eigenvector is ``svd3._eigvec``'s cross
  product of two rows of (A − λI). The other two are the eigenvectors of
  A restricted to the plane orthogonal to it, a 2 × 2 problem that one
  Jacobi rotation solves however close its roots are (Eberly, "A Robust
  Eigensolver for 3 × 3 Symmetric Matrices", with the plane diagonalised
  rather than solved from the cubic's middle root, which loses half its
  digits near a repeated root). The triple is orthonormal whatever the
  roots; a repeated root gets some orthonormal basis of its eigenspace.
* ``jacobi_eigh`` [..., n, n]: cyclic Jacobi in round-robin order, each
  round one rotation of n/2 disjoint index pairs at once, for a fixed
  number of sweeps (no convergence test).

Both run in the input's dtype; the port keeps TF32 off, so f32 matmuls
here are full f32.
"""

from __future__ import annotations

import torch

from pre3_tpu_torch.ops.svd3 import _eigvec, sym3_eigvals
from pre3_tpu_torch.utils.device import cached_constant

# Jacobi sweeps: a sweep rotates every pair once. At 12 × 12 (EPnP's MᵀM,
# random SPD matrices) the off-diagonal mass falls below f32 rounding in
# 5 sweeps and below f64 rounding in 6 (tests/test_torch_graphs_solvers.py
# holds f64 to 1e-12).
JACOBI_SWEEPS = 6


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _complement(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two unit vectors completing the unit vector w [..., 3] to an
    orthonormal basis (the larger of w's first two components is zeroed
    in neither candidate's denominator)."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w0)
    big0 = torch.abs(w0) > torch.abs(w1)
    u = torch.where(big0[..., None], torch.stack([-w2, z, w0], -1),
                    torch.stack([z, w2, -w1], -1))
    u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    return u, _cross(w, u)


def _plane_eigh(b: torch.Tensor, w: torch.Tensor):
    """The eigenpairs of symmetric b [..., 3, 3] orthogonal to its unit
    eigenvector w: b restricted to w's orthogonal complement (u, v) is a
    2 × 2 symmetric matrix, diagonalised by one Jacobi rotation of angle
    ½·atan2(2m₀₁, m₀₀ − m₁₁), which stays accurate however close its two
    eigenvalues are (the cubic's roots do not near a repeated root).
    Returns (larger, smaller) eigenvalues and their unit vectors; a
    repeated root gets (u, v) turned by an arbitrary angle."""
    u, v = _complement(w)
    bu = torch.einsum("...ij,...j->...i", b, u)
    bv = torch.einsum("...ij,...j->...i", b, v)
    m00 = torch.sum(u * bu, -1)
    m01 = torch.sum(u * bv, -1)
    m11 = torch.sum(v * bv, -1)
    phi = 0.5 * torch.atan2(2.0 * m01, m00 - m11)
    c, s = torch.cos(phi)[..., None], torch.sin(phi)[..., None]
    mean = 0.5 * (m00 + m11)
    r = torch.hypot(0.5 * (m00 - m11), m01)
    return mean + r, mean - r, c * u + s * v, c * v - s * u


def sym3_eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues ascending [..., 3] and orthonormal eigenvectors
    (columns) [..., 3, 3] of symmetric a [..., 3, 3], branch-free.

    The matrix is shifted by its mean eigenvalue and scaled by its largest
    remaining entry, so the closed form's epsilons are relative to the
    eigenvalues' spread; a multiple of the identity gives the identity
    basis."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = torch.diagonal(a, dim1=-2, dim2=-1).mean(-1)  # [...]
    b = a - q[..., None, None] * eye
    s = torch.amax(torch.abs(b), dim=(-2, -1))
    flat = s == 0
    s = torch.where(flat, 1.0, s)
    b = b / s[..., None, None]
    lam = sym3_eigvals(b)  # descending
    # the eigenvalue farther from the middle one: its eigenspace is a line
    top = (lam[..., 0] - lam[..., 1]) >= (lam[..., 1] - lam[..., 2])
    w = _eigvec(b, torch.where(top, lam[..., 0], lam[..., 2]))
    lw = torch.sum(w * torch.einsum("...ij,...j->...i", b, w), -1)
    hi, lo, e_hi, e_lo = _plane_eigh(b, w)
    t3 = top[..., None]
    vals = torch.where(t3, torch.stack([lo, hi, lw], -1),
                       torch.stack([lw, lo, hi], -1))
    t3 = t3[..., None]
    v = torch.where(t3, torch.stack([e_lo, e_hi, w], -1),
                    torch.stack([w, e_lo, e_hi], -1))
    v = torch.where(flat[..., None, None], eye, v)
    return q[..., None] + s[..., None] * torch.where(
        flat[..., None], 0.0, vals), v


def _rounds(n: int) -> torch.Tensor:
    """[n' − 1, 2, n'] per round of a round-robin tournament over n' = n
    rounded up to even: the rows and columns (p, q, p, q), (p, q, q, p)
    of the entries its rotations set, for its pairs p < q (each round
    pairs every index once and every pair meets in one round). With n odd
    the pairs with the extra index n are dropped, so each round holds
    (n − 1) / 2 of them."""
    m = n + (n % 2)
    players = list(range(m))
    out = []
    for _ in range(m - 1):
        pairs = [(min(players[k], players[m - 1 - k]),
                  max(players[k], players[m - 1 - k])) for k in range(m // 2)]
        pairs = [pq for pq in pairs if pq[1] < n]
        p, q = [a for a, _ in pairs], [b for _, b in pairs]
        out.append([p + q + p + q, p + q + q + p])
        players = [players[0], players[-1]] + players[1:-1]
    return torch.tensor(out, dtype=torch.int64)


def _rotation(app: torch.Tensor, aqq: torch.Tensor,
              apq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(c, s) of the Jacobi rotation that zeroes a_pq (Numerical Recipes
    §11.1: θ = (a_qq − a_pp) / 2a_pq, t = sgn θ / (|θ| + √(θ² + 1)), the
    smaller angle); c = 1, s = 0 where a_pq is 0."""
    zero = apq == 0
    theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
    t = torch.copysign(torch.reciprocal(
        torch.abs(theta) + torch.sqrt(theta * theta + 1.0)), theta)
    t = torch.where(zero, 0.0, t)
    c = torch.rsqrt(t * t + 1.0)
    return c, t * c


def jacobi_eigh(a: torch.Tensor,
                sweeps: int = JACOBI_SWEEPS) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Eigenvalues ascending [..., n] and orthonormal eigenvectors
    (columns) [..., n, n] of symmetric a [..., n, n]: ``sweeps`` cyclic
    Jacobi sweeps, each n − 1 (n even) rounds of n/2 disjoint rotations
    A ← JᵀAJ, V ← VJ (J set in one scatter); then a stable ascending
    sort."""
    n = a.shape[-1]
    rounds = cached_constant(("jacobi_rounds", n), lambda: _rounds(n),
                             a.device)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    v = eye.expand_as(a)
    for _ in range(sweeps):
        for rows, cols in rounds:
            k = rows.shape[0] // 4
            p, q = rows[:k], rows[k:2 * k]
            d = torch.diagonal(a, dim1=-2, dim2=-1)
            c, s = _rotation(d[..., p], d[..., q], a[..., p, q])
            j = eye.expand_as(a).clone()
            j[..., rows, cols] = torch.cat([c, c, s, -s], -1)
            a = j.transpose(-1, -2) @ a @ j
            v = v @ j
    w, order = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1,
                          stable=True)
    return w, torch.gather(v, -1, order[..., None, :].expand_as(v))
