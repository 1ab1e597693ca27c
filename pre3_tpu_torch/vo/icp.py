"""Point-to-point ICP and generalized (plane-to-plane) ICP, fixed-iteration.

Port of ``pre3_tpu/vo/icp.py``. The reference cross-checks its RANSAC VO
against ICP/GICP (TestScripts/ICP_RANSAC*.m, GICP_test_each_camera.m):
ICP is its verification oracle, not its estimator. Same role here.

Nearest neighbours are one [N, M] distance matrix per iteration (the
‖a‖² − 2a·b + ‖b‖² expansion, f32 matmul), correspondences are trimmed by
a distance threshold, and the refit is Kabsch (ops/svd3) for point to
point or one 6×6 normal-equation solve for GICP. GICP covariances
(Segal et al.: Σ = V·diag(ε,1,1)·Vᵀ from k-NN PCA) depend only on the
normal n, the smallest axis: Σ = I − (1 − ε)·n·nᵀ for any orthonormal V.
n comes from the capture-safe batched ``ops/sym_eig.sym3_eigh``, once
per cloud; its sign, like the other axes, Σ does not see. The k nearest
neighbours come from ``utils/topk.stable_topk``: where points are
invalid a row is all −inf, and the reference's ``lax.top_k`` then takes
the lowest indices.

The reference jits ``icp`` and ``gicp`` whole, the iterations one
``lax.scan``. Here each is a step program (``utils/graphs.py``) keyed by
the clouds' shapes, whether ``r0``/``t0`` are given, ``trim_dist`` and
``min_inliers`` (GICP's also by ``k_neighbors`` and ``eps``), never by
``iters``. A call copies its inputs and the start (r0, t0, or the
identity and zero) into the program's buffers in one grouped copy; GICP
replays its ``covariances`` graph once; the ``iteration`` graph (NN,
trim, refit) is replayed ``iters`` times on the carry (r, t), and the
``finish`` graph (rmse, inlier count, ok) once into a packed result row,
which is copied out. On the CPU the same bodies run eagerly.

Convention matches vo/rigid.py: solves P ≈ R·Q + t (frame-2 → frame-1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.ops.sym_eig import sym3_eigh
from pre3_tpu_torch.utils.device import cached_constant
from pre3_tpu_torch.utils.graphs import (
    Packing, call_program, keep, load, packed_result,
)
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


def _start(r0, t0, like):
    """(r0, t0), the identity and zero (constants on ``like``'s device)
    where not given."""
    dev, dt = like.device, like.dtype
    r = r0 if r0 is not None else cached_constant(
        ("icp_r0", dt), lambda: torch.eye(3, dtype=dt), dev)
    t = t0 if t0 is not None else cached_constant(
        ("icp_t0", dt), lambda: torch.zeros(3, dtype=dt), dev)
    return r, t


def _finish(p, q, valid_p, valid_q, r, t, trim_dist, min_inliers):
    idx, dist = _nn(q @ r.T + t, p, valid_p)
    inl = valid_q & (dist < trim_dist)
    n_inl = torch.sum(inl)
    rmse = torch.sqrt(torch.sum(torch.where(inl, dist * dist, 0.0))
                      / torch.clamp(n_inl, min=1))
    return IcpResult(r=r, t=t, ok=n_inl >= min_inliers, rmse=rmse,
                     n_inliers=n_inl.to(torch.int32))


def _icp_step(p, q, valid_p, valid_q, r, t, trim_dist):
    """One ICP iteration: (r, t) refit to the trimmed nearest neighbours,
    kept where the fit is degenerate."""
    idx, dist = _nn(q @ r.T + t, p, valid_p)
    w = (valid_q & (dist < trim_dist)).to(p.dtype)
    fit = kabsch(p[idx], q, w)
    return torch.where(fit.ok, fit.r, r), torch.where(fit.ok, fit.t, t)


def _result_packing(dt: torch.dtype) -> Packing:
    e = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype)  # noqa
    return Packing(IcpResult(e(3, 3), e(3), e(dtype=torch.bool), e(),
                             e(dtype=torch.int32)))


def _solve(name: str, cfg: tuple, variants: list, body, pout: Packing,
           p, q, valid_p, valid_q, r0, t0) -> IcpResult:
    """``icp``'s or ``gicp``'s call: the clouds and the start (r, t) into
    the program of (``name``, ``cfg``, whether r0/t0 are given, the
    shapes), one run of ``body(variant)`` per variant, the result row
    copied out."""
    prog = call_program(name, (cfg, r0 is None, t0 is None),
                        [p, q, valid_p, valid_q, *_start(r0, t0, p)], pout,
                        carry=("inp",))
    for v in variants:
        prog.run(v, body(v))
    return packed_result(prog, pout)


def _icp_body(trim_dist: float, min_inliers: int, pout: Packing):
    """``icp``'s program body per variant: ``iteration`` updates the
    carry (r, t, the last inputs), ``finish`` packs the result row."""

    def make(variant: str):
        def body(b, gens):
            p, q, valid_p, valid_q, r, t = b["inp"]
            if variant == "finish":
                pout.pack(_finish(p, q, valid_p, valid_q, r, t, trim_dist,
                                  min_inliers), b["out"])
            else:
                load((r, t), _icp_step(p, q, valid_p, valid_q, r, t,
                                       trim_dist))

        return body

    return make


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
    """Align q onto p. Optional initial guess (icp_with_init.m). One
    ``iteration`` replay per iteration and a ``finish`` (see the module
    docstring); the result is the call's own copy."""
    cfg, pout = (trim_dist, min_inliers), _result_packing(p.dtype)
    return _solve("icp", cfg, ["iteration"] * iters + ["finish"],
                  _icp_body(*cfg, pout), pout, p, q, valid_p, valid_q, r0,
                  t0)


def surface_covariances(
    pts: torch.Tensor,  # [N, 3]
    valid: torch.Tensor,  # [N] bool
    k: int = 8,
    eps: float = 1e-3,
) -> torch.Tensor:
    """Per-point GICP covariance Σᵢ = V·diag(ε, 1, 1)·Vᵀ where V are the
    local k-NN PCA axes (ascending eigenvalue — the first axis is the
    surface normal), as I − (1 − ε)·n·nᵀ from the normal n alone. One
    [N, N] distance matmul + the batched 3×3 ``sym3_eigh``."""
    d2 = torch.where(valid[None, :] & valid[:, None], _dist2(pts, pts),
                     torch.inf)
    _, idx = stable_topk(-d2, k)  # [N, k] nearest (incl. self)
    nb = pts[idx]  # [N, k, 3]
    mu = torch.mean(nb, dim=1, keepdim=True)
    c = torch.einsum("nka,nkb->nab", nb - mu, nb - mu) / k
    # regularize: degenerate neighborhoods fall back to isotropic
    _, v = sym3_eigh(c + 1e-9 * _eye(3, pts))
    n = v[..., 0]  # the normal: the smallest axis
    return _eye(3, pts) - (1.0 - eps) * n[:, :, None] * n[:, None, :]


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


def _gicp_step(p, q, valid_p, valid_q, cp, cq, r, t, trim_dist):
    """One GICP iteration: NN correspondences, then one Gauss–Newton step
    on the manifold, kept where at least 3 correspondences survive."""
    eye3 = _eye(3, p)
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
    return (torch.where(ok, _so3_exp(delta[3:]) @ r, r),
            torch.where(ok, t + delta[:3], t))


def _gicp_body(trim_dist: float, min_inliers: int, k_neighbors: int,
               eps: float, pout: Packing):
    """``gicp``'s program body per variant: ``covariances`` puts both
    clouds' Σ into the ``cov`` buffers, ``iteration`` updates the carry
    (r, t, the last inputs), ``finish`` packs the result row."""

    def make(variant: str):
        def body(b, gens):
            p, q, valid_p, valid_q, r, t = b["inp"]
            if variant == "covariances":
                keep(b, "cov", (
                    surface_covariances(p, valid_p, k=k_neighbors, eps=eps),
                    surface_covariances(q, valid_q, k=k_neighbors, eps=eps)))
            elif variant == "iteration":
                load((r, t), _gicp_step(p, q, valid_p, valid_q, *b["cov"],
                                        r, t, trim_dist))
            else:
                pout.pack(_finish(p, q, valid_p, valid_q, r, t, trim_dist,
                                  min_inliers), b["out"])

        return body

    return make


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
    (δ = [dt, dθ], batched 3×3 inverses, one 6×6 solve per iteration).
    The covariances once, one ``iteration`` replay per iteration and a
    ``finish`` (see the module docstring); the result is the call's own
    copy."""
    cfg = (trim_dist, min_inliers, k_neighbors, eps)
    pout = _result_packing(p.dtype)
    return _solve("gicp", cfg,
                  ["covariances"] + ["iteration"] * iters + ["finish"],
                  _gicp_body(*cfg, pout), pout, p, q, valid_p, valid_q, r0,
                  t0)
