"""Bundle adjustment: Levenberg–Marquardt with Schur-complement landmark
elimination.

Port of ``pre3_tpu/backend/ba.py``: a keyframe/landmark factor graph
where each factor is the reprojection (plus an optional RGB-D depth term)
of landmark l in keyframe f, with optional odometry-chain and
loop-closure pose factors between keyframes.

  H = [[Hcc, W], [Wᵀ, Hpp]], Hcc block-diagonal over keyframes [F, 6, 6],
  Hpp block-diagonal over landmarks [L, 3, 3], W the coupling [F, L, 6, 3].

Landmarks are eliminated in closed form (batched 3×3 inverses), the
reduced camera system S = Hcc − W Hpp⁻¹ Wᵀ (6F × 6F) is Jacobi-normalised
and solved in f32, as the reference does, and landmarks back-substitute.
Everything is masked and static-shaped: obs [F, L, 2] + mask [F, L].
Keyframe pose = (t, q) with a rotation-vector increment composed on the
manifold; keyframe 0 is frozen (gauge).

The reference differentiates each (keyframe, landmark) residual with
``jax.jacfwd`` under a double ``vmap``. Here every residual is written
batched over its factor axes, and a factor's Jacobian is the forward-mode
derivative of the batched residual along each basis direction of its own
increment (``_row_jacobian``): factors are independent, so one ``jvp``
per direction, vmapped over the directions, gives every block at once.
Batched tensors are never 0-d, so no tangent is promoted to float64.
The LM loop has a static trip count and decides accept/reject with
``torch.where``: nothing is read back to the host.

The reference jits ``bundle_adjust`` whole, its iterations one
``lax.scan``. Here it is a step program (``utils/graphs.py``) with two
variants, the initial cost (``cost0``) and one LM iteration
(``iteration``), keyed by the problem's shapes (which optional factors
are present included), ``fixed_first``, ``depth_range_ref`` and the
factor weights, never by ``iters``: on the card a solve copies the
problem into the program's buffers, replays the cost graph once and the
iteration graph ``iters`` times, each updating the carry (poses, points,
λ, the current cost) in place; on the CPU the same bodies run eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from pre3_tpu_torch.geometry.camera import Camera, distort, project_point
from pre3_tpu_torch.geometry.quaternion import (
    q2v, qconj, qnormalize, qprod, qrotate, v2q,
)
from pre3_tpu_torch.utils.graphs import (
    Packing, StepProgram, empty_like_tree, load, program, shape_key,
)


class BaProblem(NamedTuple):
    obs_uv: torch.Tensor  # [F, L, 2] observed pixels
    mask: torch.Tensor  # [F, L] bool
    kf_t: torch.Tensor  # [F, 3] initial keyframe positions (world)
    kf_q: torch.Tensor  # [F, 4] initial keyframe orientations (cam→world)
    points: torch.Tensor  # [L, 3] initial landmark positions (world)
    # optional RGB-D depth factors: camera-frame 3D observations
    obs_xyz: torch.Tensor | None = None  # [F, L, 3]
    mask_xyz: torch.Tensor | None = None  # [F, L]
    # optional odometry factors between consecutive keyframes
    odo_t: torch.Tensor | None = None  # [F-1, 3] R_iᵀ(t_{i+1}−t_i)
    odo_q: torch.Tensor | None = None  # [F-1, 4] q_i⁻¹ ⊗ q_{i+1}
    odo_w: torch.Tensor | None = None  # [F-1] per-pair weight (0 disables)
    # loop-closure landmarks: their factors are not Huber-down-weighted
    lc_lm: torch.Tensor | None = None  # [L] bool
    # keyframe-pair loop-closure pose factors (lcp_t = R_iᵀ(t_j − t_i),
    # lcp_q = q_i⁻¹ ⊗ q_j; lcp_w = 0 disables a slot)
    lcp_i: torch.Tensor | None = None  # [G] int32
    lcp_j: torch.Tensor | None = None  # [G] int32
    lcp_t: torch.Tensor | None = None  # [G, 3]
    lcp_q: torch.Tensor | None = None  # [G, 4]
    lcp_w: torch.Tensor | None = None  # [G]
    # optional per-factor square-root information [G, 6, 6] (rows [t, ω]);
    # replaces the scalar lcp weights when present
    lcp_info: torch.Tensor | None = None


class BaResult(NamedTuple):
    kf_t: torch.Tensor
    kf_q: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor  # [iters+1] masked mean factor cost


def _row_jacobian(fn, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(fn(x), J) for a function that maps every row x[..., :] on its
    own: J [..., n_out, n_in] holds each row's Jacobian, from one
    forward-mode derivative per input direction."""
    n_in = x.shape[-1]
    basis = torch.eye(n_in, dtype=x.dtype, device=x.device)

    def column(e):
        return jvp(fn, (x,), (e.expand_as(x),))

    out, cols = vmap(column)(basis)  # [n_in, ..., n_out] each
    return out[0], cols.movedim(0, -1)


def _residual_one(cam: Camera, t, q, dx, p, uv, xyz, w_px, w_xyz):
    """Stacked residual [..., 5] of (keyframe, landmark) pairs with pose
    increments dx = [dt, dθ] applied on the manifold, T ← (t + dt,
    q ⊗ exp(dθ)). Rows 0:2 reprojection (pixels·w_px), rows 2:5 the
    camera-frame depth factor (meters·w_xyz). w_px, w_xyz [..., 1]."""
    t2 = t + dx[..., :3]
    q2 = qprod(q, v2q(dx[..., 3:]))
    p_cam = qrotate(qconj(q2), p - t2)
    r_px = (distort(cam, project_point(cam, p_cam)) - uv) * w_px
    r_xyz = (p_cam - xyz) * w_xyz
    return torch.cat([r_px, r_xyz], dim=-1)


def _odo_residual(ti, qi, tj, qj, dxi, dxj, ot, oq, w_t, w_r):
    """[..., 6] relative-pose residual between keyframe pairs with
    manifold increments dxi/dxj = [dt, dθ]: the translation residual in
    frame i and the rotation vector of the orientation error."""
    t1, q1 = ti + dxi[..., :3], qprod(qi, v2q(dxi[..., 3:]))
    t2, q2 = tj + dxj[..., :3], qprod(qj, v2q(dxj[..., 3:]))
    r_t = (qrotate(qconj(q1), t2 - t1) - ot) * w_t
    r_r = q2v(qprod(qconj(oq), qprod(qconj(q1), q2))) * w_r
    return torch.cat([r_t, r_r], dim=-1)


def _pair_residual_jacobians(kf_t, kf_q, i_idx, j_idx, rel_t, rel_q,
                             w_t, w_r, w, w_mat=None):
    """Residuals and Jacobian blocks of relative-pose factors between
    arbitrary keyframe pairs (i_idx, j_idx): (r [G, 6], ji [G, 6, 6],
    jj [G, 6, 6]). With w_mat [G, 6, 6] (square-root information) the
    whitened residual is w·(L @ r_raw); otherwise the scalar weights
    (w_t, w_r)·w apply."""
    i_idx, j_idx = i_idx.to(torch.int64), j_idx.to(torch.int64)
    ti, qi, tj, qj = kf_t[i_idx], kf_q[i_idx], kf_t[j_idx], kf_q[j_idx]
    zero = torch.zeros((i_idx.shape[0], 6), dtype=kf_t.dtype,
                       device=kf_t.device)
    wv = w[:, None]
    if w_mat is None:
        def res(di, dj):
            return _odo_residual(ti, qi, tj, qj, di, dj, rel_t, rel_q,
                                 w_t * wv, w_r * wv)
    else:
        def res(di, dj):
            raw = _odo_residual(ti, qi, tj, qj, di, dj, rel_t, rel_q, 1.0,
                                1.0)
            return wv * torch.einsum("gab,gb->ga", w_mat, raw)
    r, ji = _row_jacobian(lambda d: res(d, zero), zero)
    _, jj = _row_jacobian(lambda d: res(zero, d), zero)
    return r, ji, jj


def _pair_terms(kf_t, kf_q, i_idx, j_idx, rel_t, rel_q, w_t, w_r, w,
                w_mat=None):
    """Gauss-Newton contribution of keyframe-pair factors, added straight
    to the reduced camera system: (s_add [F, 6, F, 6], rhs_add [F, 6],
    cost_sum, n_factors). Duplicate (i, j) pairs accumulate."""
    f = kf_t.shape[0]
    r, ji, jj = _pair_residual_jacobians(kf_t, kf_q, i_idx, j_idx, rel_t,
                                         rel_q, w_t, w_r, w, w_mat)
    i_idx, j_idx = i_idx.to(torch.int64), j_idx.to(torch.int64)
    blocks = torch.zeros((f, f, 6, 6), dtype=kf_t.dtype, device=kf_t.device)
    cross = torch.einsum("pab,pac->pbc", ji, jj)  # [G, 6, 6]
    for a, b, v in ((i_idx, i_idx, torch.einsum("pab,pac->pbc", ji, ji)),
                    (j_idx, j_idx, torch.einsum("pab,pac->pbc", jj, jj)),
                    (i_idx, j_idx, cross),
                    (j_idx, i_idx, cross.transpose(-1, -2))):
        blocks.index_put_((a, b), v, accumulate=True)
    rhs_add = torch.zeros((f, 6), dtype=kf_t.dtype, device=kf_t.device)
    rhs_add.index_add_(0, i_idx, -torch.einsum("pab,pa->pb", ji, r))
    rhs_add.index_add_(0, j_idx, -torch.einsum("pab,pa->pb", jj, r))
    return (blocks.permute(0, 2, 1, 3), rhs_add, torch.sum(r * r),
            torch.sum(w > 0))


def _odo_terms(kf_t, kf_q, odo_t, odo_q, w_t, w_r, odo_w=None):
    """Gauss-Newton contribution of the keyframe odometry chain — the
    adjacent-pair case of _pair_terms."""
    f = kf_t.shape[0]
    if odo_w is None:
        odo_w = torch.ones(f - 1, dtype=kf_t.dtype, device=kf_t.device)
    ar = torch.arange(f, device=kf_t.device)
    return _pair_terms(kf_t, kf_q, ar[:-1], ar[1:], odo_t, odo_q, w_t, w_r,
                       odo_w)


def _pair_args(kf_t, kf_q, points, obs_uv, obs_xyz, w_xyz_fl, mask):
    """The per-pair inputs of _residual_one, batched [F, L, ...]."""
    t = kf_t[:, None, :]
    q = kf_q[:, None, :]
    # materialised: a landmark's Jacobian is taken per (keyframe, landmark)
    p = points[None].expand(kf_t.shape[0], -1, -1).clone()
    w_px = mask.to(obs_uv.dtype)[..., None]
    return t, q, p, w_px, w_xyz_fl[..., None]


def _build_normal_eqs(cam, kf_t, kf_q, points, obs_uv, mask,
                      obs_xyz, w_xyz_fl, damping, huber_delta=3.0):
    """One linearization: masked J/r over the [F, L] grid → blocks
    (hcc [F,6,6], hpp [L,3,3], wcp [F,L,6,3], bc [F,6], bp [L,3])."""
    f, l = mask.shape
    t, q, p, w_px, w_xyz = _pair_args(kf_t, kf_q, points, obs_uv, obs_xyz,
                                      w_xyz_fl, mask)
    zero = torch.zeros((f, l, 6), dtype=kf_t.dtype, device=kf_t.device)
    r, jc = _row_jacobian(lambda d: _residual_one(
        cam, t, q, d, p, obs_uv, obs_xyz, w_px, w_xyz), zero)  # [F,L,5,6]
    _, jp = _row_jacobian(lambda pp: _residual_one(
        cam, t, q, zero, pp, obs_uv, obs_xyz, w_px, w_xyz), p)  # [F,L,5,3]

    # Huber IRLS: per-pair weight min(1, δ/‖r‖) on both J and r
    rnorm = torch.linalg.vector_norm(r, dim=-1)  # [F, L]
    wr = torch.sqrt(torch.clamp(huber_delta / torch.clamp(rnorm, min=1e-9),
                                max=1.0))
    r = r * wr[..., None]
    jc = jc * wr[..., None, None]
    jp = jp * wr[..., None, None]

    hcc = torch.einsum("flab,flac->fbc", jc, jc)
    hpp = torch.einsum("flab,flac->lbc", jp, jp)
    wcp = torch.einsum("flab,flac->flbc", jc, jp)
    bc = -torch.einsum("flab,fla->fb", jc, r)
    bp = -torch.einsum("flab,fla->lb", jp, r)
    eye6 = torch.eye(6, dtype=kf_t.dtype, device=kf_t.device)
    eye3 = torch.eye(3, dtype=kf_t.dtype, device=kf_t.device)
    return hcc + damping * eye6, hpp + damping * eye3, wcp, bc, bp


def schur_solve(hcc, hpp, wcp, bc, bp, fixed_first: bool = True,
                s_extra=None, rhs_extra=None):
    """Eliminate landmarks, solve the reduced camera system,
    back-substitute. s_extra/rhs_extra: camera-camera factor terms added
    before the gauge fix. Returns (dc [F, 6], dp [L, 3])."""
    f = hcc.shape[0]
    dt, dev = hcc.dtype, hcc.device
    hpp_inv, _ = torch.linalg.inv_ex(hpp)  # [L, 3, 3]
    # S = Hcc_blockdiag − Σ_l W_fl Hpp_l⁻¹ W_glᵀ → [F, 6, F, 6]
    s = -torch.einsum("flab,lbc,gldc->fagd", wcp, hpp_inv, wcp)
    ar = torch.arange(f, device=dev)
    s[ar, :, ar, :] += hcc
    rhs = bc - torch.einsum("flab,lbc,lc->fa", wcp, hpp_inv, bp)
    if s_extra is not None:
        s = s + s_extra
        rhs = rhs + rhs_extra
    if fixed_first:
        # gauge: freeze keyframe 0 (zero rows/cols, identity block)
        keep = torch.ones(f, dtype=dt, device=dev)
        keep[0].fill_(0.0)
        s = s * keep[:, None, None, None] * keep[None, None, :, None]
        s[0, :, 0, :] = torch.eye(6, dtype=dt, device=dev)
        rhs = rhs * keep[:, None]
    # Jacobi normalization before the f32 solve (the raw system has cond
    # ~1e8); algebraically exact
    sd = s.reshape(f * 6, f * 6)
    d = torch.sqrt(torch.clamp(torch.diagonal(sd), min=1e-12))
    sn = sd / d[:, None] / d[None, :]
    y, _ = torch.linalg.solve_ex(sn, rhs.reshape(-1) / d)
    dc = (y / d).reshape(f, 6)
    dp = torch.einsum("lab,lb->la", hpp_inv,
                      bp - torch.einsum("flab,fa->lb", wcp, dc))
    return dc, dp


def _cost_sums(cam, kf_t, kf_q, points, obs_uv, mask, obs_xyz, w_xyz_fl,
               huber_delta=3.0):
    """(Σ Huber cost, factor count) over the landmark factors."""
    f, l = mask.shape
    t, q, p, w_px, w_xyz = _pair_args(kf_t, kf_q, points, obs_uv, obs_xyz,
                                      w_xyz_fl, mask)
    zero = torch.zeros((f, l, 6), dtype=kf_t.dtype, device=kf_t.device)
    r = _residual_one(cam, t, q, zero, p, obs_uv, obs_xyz, w_px, w_xyz)
    rn = torch.linalg.vector_norm(r, dim=-1)
    rho = torch.where(rn <= huber_delta, rn * rn,
                      huber_delta * (2.0 * rn - huber_delta))
    n = torch.sum(mask) + torch.sum(w_xyz_fl > 0)
    return torch.sum(rho), n


def _odo_cost_sums(kf_t, kf_q, odo):
    """(Σ odo-chain cost, factor count)."""
    odo_t, odo_q, w_t, w_r, odo_w = odo
    zero = torch.zeros((kf_t.shape[0] - 1, 6), dtype=kf_t.dtype,
                       device=kf_t.device)
    ro = _odo_residual(kf_t[:-1], kf_q[:-1], kf_t[1:], kf_q[1:], zero, zero,
                       odo_t, odo_q, w_t * odo_w[:, None],
                       w_r * odo_w[:, None])
    return torch.sum(ro * ro), torch.sum(odo_w > 0)


def _pair_cost_sums(kf_t, kf_q, pair):
    """(Σ pair-factor cost, factor count); pair = (i_idx, j_idx, rel_t,
    rel_q, w_t, w_r, w, w_mat-or-None)."""
    i_idx, j_idx, rel_t, rel_q, w_t, w_r, w, w_mat = pair
    i_idx, j_idx = i_idx.to(torch.int64), j_idx.to(torch.int64)
    zero = torch.zeros((i_idx.shape[0], 6), dtype=kf_t.dtype,
                       device=kf_t.device)
    args = (kf_t[i_idx], kf_q[i_idx], kf_t[j_idx], kf_q[j_idx], zero, zero,
            rel_t, rel_q)
    if w_mat is None:
        r = _odo_residual(*args, w_t * w[:, None], w_r * w[:, None])
    else:
        r = w[:, None] * torch.einsum("gab,gb->ga", w_mat,
                                      _odo_residual(*args, 1.0, 1.0))
    return torch.sum(r * r), torch.sum(w > 0)


def _cost(cam, kf_t, kf_q, points, obs_uv, mask, obs_xyz, w_xyz_fl,
          huber_delta=3.0, odo=None, lcp=None):
    """Masked mean factor cost: landmark factors (Huber), plus the
    odometry chain (odo = (odo_t, odo_q, w_t, w_r, odo_w)) and the
    loop-closure pose factors (lcp, a _pair_cost_sums tuple)."""
    total, n = _cost_sums(cam, kf_t, kf_q, points, obs_uv, mask, obs_xyz,
                          w_xyz_fl, huber_delta)
    if odo is not None:
        ot, on = _odo_cost_sums(kf_t, kf_q, odo)
        total, n = total + ot, n + on
    if lcp is not None:
        pt, pn = _pair_cost_sums(kf_t, kf_q, lcp)
        total, n = total + pt, n + pn
    return total / torch.clamp(n, min=1)


def _depth_weights(mask_xyz, obs_xyz, depth_weight: float,
                   depth_range_ref: float, dtype) -> torch.Tensor:
    """Per-observation depth-factor weights [F, L]: the constant
    depth_weight, or with depth_range_ref > 0 the SR4000 range-noise
    model depth_weight·(ref/range)²."""
    w = mask_xyz.to(dtype) * depth_weight
    if depth_range_ref > 0:
        rng = torch.clamp(torch.linalg.vector_norm(obs_xyz, dim=-1), min=0.4)
        w = w * (depth_range_ref / rng) ** 2
    return w


class _Terms(NamedTuple):
    """A problem's factor set with its defaults filled in, as every LM
    iteration reads it."""

    odo: tuple | None  # (odo_t, odo_q, w_t, w_r, odo_w)
    lcp: tuple | None  # (i, j, rel_t, rel_q, w_t, w_r, w, w_mat-or-None)
    obs_xyz: torch.Tensor  # [F, L, 3] (zeros without depth factors)
    w_xyz_fl: torch.Tensor  # [F, L] depth-factor weights
    hub: torch.Tensor | float  # Huber δ: [1, L] with lc_lm, else 3.0


def _terms(problem: BaProblem, depth_weight: float, odo_weight_t: float,
           odo_weight_r: float, depth_range_ref: float, lcp_weight_t: float,
           lcp_weight_r: float) -> _Terms:
    """The factor set of ``problem``: its absent weights and depth
    observations are device fills, never host copies."""
    f, l = problem.mask.shape
    dt, dev = problem.kf_t.dtype, problem.kf_t.device
    odo = None
    if problem.odo_t is not None:
        odo_w = problem.odo_w if problem.odo_w is not None else torch.ones(
            f - 1, dtype=dt, device=dev)
        odo = (problem.odo_t, problem.odo_q, odo_weight_t, odo_weight_r,
               odo_w)
    lcp = ((problem.lcp_i, problem.lcp_j, problem.lcp_t, problem.lcp_q,
            lcp_weight_t, lcp_weight_r,
            problem.lcp_w if problem.lcp_w is not None else torch.ones(
                problem.lcp_i.shape[0], dtype=dt, device=dev),
            problem.lcp_info)
           if problem.lcp_i is not None else None)
    if problem.obs_xyz is None:
        obs_xyz = torch.zeros((f, l, 3), dtype=dt, device=dev)
        w_xyz_fl = torch.zeros((f, l), dtype=dt, device=dev)
    else:
        obs_xyz = problem.obs_xyz
        mask_xyz = (problem.mask_xyz if problem.mask_xyz is not None
                    else problem.mask)
        w_xyz_fl = _depth_weights(problem.mask & mask_xyz, obs_xyz,
                                  depth_weight, depth_range_ref, dt)
    # loop-closure landmarks keep full quadratic weight
    hub = (torch.where(problem.lc_lm[None, :], 1e6, 3.0).to(dt)
           if problem.lc_lm is not None else 3.0)
    return _Terms(odo, lcp, obs_xyz, w_xyz_fl, hub)


def _problem_cost(cam: Camera, problem: BaProblem, terms: _Terms, kf_t,
                  kf_q, points) -> torch.Tensor:
    """The masked mean factor cost of ``problem`` at an iterate."""
    return _cost(cam, kf_t, kf_q, points, problem.obs_uv, problem.mask,
                 terms.obs_xyz, terms.w_xyz_fl, huber_delta=terms.hub,
                 odo=terms.odo, lcp=terms.lcp)


def _lm_step(cam: Camera, problem: BaProblem, terms: _Terms,
             fixed_first: bool, kf_t, kf_q, points, lam, c0):
    """One LM iteration (the reference's ``gn_step``) from an iterate and
    its cost ``c0``: (kf_t, kf_q, points, λ, the kept cost). A step that
    raises the cost is rejected and λ raised ×10; an accepted one lowers
    λ ×0.5."""
    hcc, hpp, wcp, bc, bp = _build_normal_eqs(
        cam, kf_t, kf_q, points, problem.obs_uv, problem.mask, terms.obs_xyz,
        terms.w_xyz_fl, lam, huber_delta=terms.hub)
    s_extra = rhs_extra = None
    if terms.odo is not None:
        s_extra, rhs_extra, _, _ = _odo_terms(kf_t, kf_q, *terms.odo)
    if terms.lcp is not None:
        s_lc, rhs_lc, _, _ = _pair_terms(kf_t, kf_q, *terms.lcp)
        s_extra = s_lc if s_extra is None else s_extra + s_lc
        rhs_extra = rhs_lc if rhs_extra is None else rhs_extra + rhs_lc
    dc, dp = schur_solve(hcc, hpp, wcp, bc, bp, fixed_first, s_extra,
                         rhs_extra)
    t2 = kf_t + dc[:, :3]
    q2 = qnormalize(qprod(kf_q, v2q(dc[:, 3:])))
    p2 = points + dp
    c1 = _problem_cost(cam, problem, terms, t2, q2, p2)
    better = c1 < c0
    return (torch.where(better, t2, kf_t), torch.where(better, q2, kf_q),
            torch.where(better, p2, points),
            torch.where(better, torch.clamp(lam * 0.5, min=1e-8),
                        torch.clamp(lam * 10.0, max=1e6)),
            torch.where(better, c1, c0))


def _ba_body(cam: Camera, fixed_first: bool, weights: tuple,
             carry: Packing):
    """``bundle_adjust``'s program body over its buffers, per variant: the
    problem from the ``problem`` buffers; the carry row holds (kf_t,
    kf_q, points, λ, the current cost). ``cost0`` puts the initial
    iterate and its cost into the carry (λ is the caller's fill);
    ``iteration`` runs ``_lm_step`` on the carry."""

    def make(variant: str):
        def body(b, gens):
            problem = b["problem"]
            terms = _terms(problem, *weights)
            kf_t, kf_q, points, lam, c0 = state = carry.unpack(b["carry"])
            if variant == "cost0":
                new = (problem.kf_t, problem.kf_q, problem.points, lam,
                       _problem_cost(cam, problem, terms, problem.kf_t,
                                     problem.kf_q, problem.points))
            else:
                new = _lm_step(cam, problem, terms, fixed_first, kf_t, kf_q,
                               points, lam, c0)
            load(state, new)

        return body

    return make


def bundle_adjust(
    cam: Camera,
    problem: BaProblem,
    iters: int = 10,
    damping: float = 1e-3,
    fixed_first: bool = True,
    depth_weight: float = 50.0,
    odo_weight_t: float = 20.0,
    odo_weight_r: float = 50.0,
    depth_range_ref: float = 0.0,
    lcp_weight_t: float = 20.0,
    lcp_weight_r: float = 50.0,
) -> BaResult:
    """Fixed-iteration Levenberg–Marquardt BA: a step that raises the
    cost is rejected and λ raised ×10, an accepted step lowers it ×0.5,
    all as tensor selects. depth_weight: weight of the 3D depth factors
    (1/m); odo_weight_t/r and lcp_weight_t/r: weights of the odometry and
    loop-closure pose factors (1/m, 1/rad)."""
    weights = (depth_weight, odo_weight_t, odo_weight_r, depth_range_ref,
               lcp_weight_t, lcp_weight_r)
    dt, dev = problem.kf_t.dtype, problem.kf_t.device
    scalar = torch.empty((), dtype=dt)
    carry = Packing((problem.kf_t, problem.kf_q, problem.points, scalar,
                     scalar))

    def make():
        bufs = dict(problem=empty_like_tree(problem),
                    carry=carry.rows(device=dev))
        return StepProgram("bundle_adjust", bufs, dev, carry=("carry",))

    prog = program(("bundle_adjust", cam, fixed_first, weights,
                    shape_key(problem)), make)
    b = prog.buffers
    load(b["problem"], problem)
    *_, lam, c0 = carry.unpack(b["carry"])
    lam.fill_(damping)
    body = _ba_body(cam, fixed_first, weights, carry)
    cost = torch.empty(iters + 1, dtype=dt, device=dev)
    for i, variant in enumerate(["cost0"] + ["iteration"] * iters):
        prog.run(variant, body(variant))
        cost[i].copy_(c0)
    kf_t, kf_q, points, _, _ = carry.unpack(b["carry"].clone())
    return BaResult(kf_t=kf_t, kf_q=kf_q, points=points, cost=cost)
