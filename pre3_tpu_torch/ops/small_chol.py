"""Unrolled batched Cholesky solve for tiny SPD systems.

Port of ``pre3_tpu/ops/small_chol.py``. The EKF's 1-point/3-point RANSAC
solves B≈256 independent 6×6 (or 2×2) SPD systems S·y = ν per step; for a
fixed tiny n the factorization unrolls into ~n²/2 scalar recurrences that
run as elementwise ops over the batch, with no solver call and no host
sync (used by ekf/one_point_ransac.py).
"""

from __future__ import annotations

import torch


def chol_solve_unrolled(s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S·y = b for batched SPD S.

    s: [..., n, n] SPD (n small — intended n ≤ 8)
    b: [..., n]
    returns y: [..., n]

    Unrolled Cholesky S = L·Lᵀ (pivots clamped at 1e-30, as the
    reference), then forward and back substitution.
    """
    n = s.shape[-1]
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        d = s[..., j, j]
        for k in range(j):
            d = d - l[j][k] * l[j][k]
        ljj = torch.sqrt(torch.clamp(d, min=1e-30))
        l[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, n):
            v = s[..., i, j]
            for k in range(j):
                v = v - l[i][k] * l[j][k]
            l[i][j] = v * inv
    # forward: L z = b
    z = [None] * n
    for i in range(n):
        v = b[..., i]
        for k in range(i):
            v = v - l[i][k] * z[k]
        z[i] = v / l[i][i]
    # back: Lᵀ y = z
    y = [None] * n
    for i in reversed(range(n)):
        v = z[i]
        for k in range(i + 1, n):
            v = v - l[k][i] * y[k]
        y[i] = v / l[i][i]
    return torch.stack(y, dim=-1)
