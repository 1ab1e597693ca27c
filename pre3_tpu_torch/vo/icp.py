"""Point-to-point ICP and generalized (plane-to-plane) ICP, fixed-iteration.

Port of ``pre3_tpu/vo/icp.py``. The reference cross-checks its RANSAC VO
against ICP/GICP (TestScripts/ICP_RANSAC*.m, GICP_test_each_camera.m):
ICP is its verification oracle, not its estimator. Same role here.

Nearest neighbours are one [N, M] distance matrix per iteration (the
‖a‖² − 2a·b + ‖b‖² expansion, f32 matmul), correspondences are trimmed by
a distance threshold, and the refit is Kabsch (ops/svd3) for point to
point or one 6×6 normal-equation solve for GICP, for a fixed iteration
count (the reference's ``lax.scan`` is a loop of the same length). GICP
covariances (Segal et al.: Σ = V·diag(ε,1,1)·Vᵀ from k-NN PCA) are
computed once per cloud with a batched 3×3 ``eigh``; its eigenvectors are
unique only up to sign, which Σ does not see. The k nearest neighbours
come from ``utils/topk.stable_topk``: where points are invalid a row is
all −inf, and the reference's ``lax.top_k`` then takes the lowest
indices. ``torch.linalg.eigh`` checks its result and waits for the card;
these are offline solvers, off every per-frame path.

Convention matches vo/rigid.py: solves P ≈ R·Q + t (frame-2 → frame-1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.utils.topk import stable_topk
from pre3_tpu_torch.vo.rigid import kabsch


class IcpResult(NamedTuple):
    r: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]
    ok: torch.Tensor  # [] bool
    rmse: torch.Tensor  # [] inlier RMS distance
    n_inliers: torch.Tensor  # [] int32


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (torch.sum(a * a, -1)[:, None] - 2.0 * a @ b.T
            + torch.sum(b * b, -1)[None, :])


def _nn(a: torch.Tensor, b: torch.Tensor, valid_b: torch.Tensor):
    """For each row of a [N,3], index+distance of nearest valid b [M,3]."""
    d2 = torch.where(valid_b[None, :], _dist2(a, b), torch.inf)
    idx = torch.argmin(d2, dim=-1)
    best = torch.gather(d2, 1, idx[:, None])[:, 0]
    return idx, torch.sqrt(torch.clamp(best, min=0.0))


def _init(r0, t0, like):
    r = _eye(3, like) if r0 is None else r0
    t = torch.zeros(3, dtype=like.dtype, device=like.device) if t0 is None \
        else t0
    return r, t


def _finish(p, q, valid_p, valid_q, r, t, trim_dist, min_inliers):
    idx, dist = _nn(q @ r.T + t, p, valid_p)
    inl = valid_q & (dist < trim_dist)
    n_inl = torch.sum(inl)
    rmse = torch.sqrt(torch.sum(torch.where(inl, dist * dist, 0.0))
                      / torch.clamp(n_inl, min=1))
    return IcpResult(r=r, t=t, ok=n_inl >= min_inliers, rmse=rmse,
                     n_inliers=n_inl.to(torch.int32))


def icp(
    p: torch.Tensor,  # [N, 3] target (frame 1)
    q: torch.Tensor,  # [M, 3] source (frame 2)
    valid_p: torch.Tensor,
    valid_q: torch.Tensor,
    iters: int = 20,
    trim_dist: float = 0.25,
    r0: torch.Tensor | None = None,
    t0: torch.Tensor | None = None,
    min_inliers: int = 6,
) -> IcpResult:
    """Align q onto p. Optional initial guess (icp_with_init.m)."""
    r, t = _init(r0, t0, p)
    for _ in range(iters):
        idx, dist = _nn(q @ r.T + t, p, valid_p)
        w = (valid_q & (dist < trim_dist)).to(p.dtype)
        fit = kabsch(p[idx], q, w)
        r = torch.where(fit.ok, fit.r, r)
        t = torch.where(fit.ok, fit.t, t)
    return _finish(p, q, valid_p, valid_q, r, t, trim_dist, min_inliers)


def surface_covariances(
    pts: torch.Tensor,  # [N, 3]
    valid: torch.Tensor,  # [N] bool
    k: int = 8,
    eps: float = 1e-3,
) -> torch.Tensor:
    """Per-point GICP covariance Σᵢ = V·diag(ε, 1, 1)·Vᵀ where V are the
    local k-NN PCA axes (ascending eigenvalue — the first axis is the
    surface normal). One [N, N] distance matmul + batched 3×3 eigh."""
    d2 = torch.where(valid[None, :] & valid[:, None], _dist2(pts, pts),
                     torch.inf)
    _, idx = stable_topk(-d2, k)  # [N, k] nearest (incl. self)
    nb = pts[idx]  # [N, k, 3]
    mu = torch.mean(nb, dim=1, keepdim=True)
    c = torch.einsum("nka,nkb->nab", nb - mu, nb - mu) / k
    # regularize: degenerate neighborhoods fall back to isotropic
    _, v = torch.linalg.eigh(c + 1e-9 * _eye(3, pts))  # v[:, :, 0] = normal
    d = torch.tensor([eps, 1.0, 1.0], dtype=pts.dtype).to(pts.device)
    return torch.einsum("nab,b,ncb->nac", v, d, v)  # [N, 3, 3]


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exp map [3] → [3, 3] (safe at 0)."""
    th = torch.clamp(torch.linalg.vector_norm(w), min=1e-12)
    k = w / th
    z = torch.zeros_like(k[0])
    kx = torch.stack([
        torch.stack([z, -k[2], k[1]]),
        torch.stack([k[2], z, -k[0]]),
        torch.stack([-k[1], k[0], z]),
    ])
    return _eye(3, w) + torch.sin(th) * kx + (1.0 - torch.cos(th)) * (kx @ kx)


def _neg_skew(a: torch.Tensor) -> torch.Tensor:
    """[M, 3] → [M, 3, 3] skew(a) as the reference lays it out, negated
    where it builds J = [I | −skew(q_w)]."""
    z = torch.zeros_like(a[:, 0])
    sk = torch.stack([
        torch.stack([z, -a[:, 2], a[:, 1]], -1),
        torch.stack([a[:, 2], z, -a[:, 0]], -1),
        torch.stack([-a[:, 1], a[:, 0], z], -1),
    ], dim=1)
    return -sk


def gicp(
    p: torch.Tensor,  # [N, 3] target (frame 1)
    q: torch.Tensor,  # [M, 3] source (frame 2)
    valid_p: torch.Tensor,
    valid_q: torch.Tensor,
    iters: int = 20,
    trim_dist: float = 0.25,
    r0: torch.Tensor | None = None,
    t0: torch.Tensor | None = None,
    min_inliers: int = 6,
    k_neighbors: int = 8,
    eps: float = 1e-3,
) -> IcpResult:
    """Plane-to-plane GICP: minimizes Σ dᵀ(Σp + RΣqRᵀ)⁻¹d over (R, t) by
    iterating NN correspondence + one Gauss-Newton step on the manifold
    (δ = [dt, dθ], batched 3×3 inverses, one 6×6 solve per iteration)."""
    cp = surface_covariances(p, valid_p, k=k_neighbors, eps=eps)
    cq = surface_covariances(q, valid_q, k=k_neighbors, eps=eps)
    r, t = _init(r0, t0, p)
    eye3 = _eye(3, p)
    for _ in range(iters):
        q_w = q @ r.T + t
        idx, dist = _nn(q_w, p, valid_p)
        w = (valid_q & (dist < trim_dist)).to(p.dtype)  # [M]
        d = p[idx] - q_w  # [M, 3] residuals
        m, _ = torch.linalg.inv_ex(
            cp[idx] + torch.einsum("ab,nbc,dc->nad", r, cq, r) + 1e-9 * eye3)
        m = m * w[:, None, None]
        # J_i = ∂(Rq+t)/∂[dt, dθ] = [I | −skew(q_w)] (left perturbation)
        jac = torch.cat([eye3.expand(q.shape[0], 3, 3), _neg_skew(q_w)],
                        dim=-1)  # [M, 3, 6]
        h = torch.einsum("nia,nij,njb->ab", jac, m, jac) + 1e-8 * _eye(6, p)
        g = torch.einsum("nia,nij,nj->a", jac, m, d)
        delta = torch.linalg.solve_ex(h, g)[0]  # [6]
        ok = torch.sum(w) >= 3
        r = torch.where(ok, _so3_exp(delta[3:]) @ r, r)
        t = torch.where(ok, t + delta[:3], t)
    return _finish(p, q, valid_p, valid_q, r, t, trim_dist, min_inliers)
