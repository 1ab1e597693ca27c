"""Distributed bundle adjustment: landmark blocks sharded over a process
mesh.

Port of ``pre3_tpu/parallel/ba_sharded.py``. The map is partitioned by
landmarks across the mesh axis "lm": every rank linearizes and eliminates
its landmark shard locally (batched 3×3 inverses), the reduced camera
system — small, [6F, 6F] — is summed across the ranks by one all-reduce,
solved redundantly on every rank, and landmark updates back-substitute
locally with no further communication. Per LM iteration the collectives
are one all-reduce of S [F·6·F·6] with rhs [F·6] packed beside it, and
one of the two cost sums; the final points are all-gathered once.

The LM decision ``c1 < c0`` stays a tensor: both costs come from an
all-reduce, so every rank holds the same bits and takes the same branch
of each ``torch.where``. Nothing is read back to the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pre3_tpu_torch.backend.ba import (
    BaProblem, BaResult, _build_normal_eqs, _cost_sums, _depth_weights,
    _odo_cost_sums, _odo_terms, _pair_cost_sums, _pair_terms,
)
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.quaternion import qnormalize, qprod, v2q
from pre3_tpu_torch.parallel.distributed import globalize_replicated
from pre3_tpu_torch.parallel.mesh import Mesh, all_gather, psum, shard_batch


def _pad_landmarks(problem: BaProblem, n_devices: int
                   ) -> tuple[BaProblem, int]:
    """Pad the landmark axis to a multiple of the mesh size."""
    f, l = problem.mask.shape
    lp = (l + n_devices - 1) // n_devices * n_devices
    if lp == l:
        return problem, l
    padl = lp - l

    def pad(x, axis):
        if x is None:
            return None
        width = [0, 0] * (x.ndim - axis - 1) + [0, padl]
        return F.pad(x, width)

    return (
        problem._replace(
            obs_uv=pad(problem.obs_uv, 1),
            mask=pad(problem.mask, 1),
            points=pad(problem.points, 0),
            obs_xyz=pad(problem.obs_xyz, 1),
            mask_xyz=pad(problem.mask_xyz, 1),
            lc_lm=pad(problem.lc_lm, 0),
        ),
        l,
    )


def bundle_adjust_sharded(
    mesh: Mesh,
    cam: Camera,
    problem: BaProblem,
    iters: int = 10,
    damping: float = 1e-3,
    depth_weight: float = 50.0,
    odo_weight_t: float = 20.0,
    odo_weight_r: float = 50.0,
    depth_range_ref: float = 0.0,
    lcp_weight_t: float = 20.0,
    lcp_weight_r: float = 50.0,
    axis: str = "lm",
) -> BaResult:
    """Landmark-sharded BA: backend.ba.bundle_adjust's math, with the
    reduced system summed over the ranks (the sum only reorders the f32
    reduction). The keyframe odometry-chain factors (odo_t/odo_q/odo_w)
    and the loop-closure pose factors (lcp_*) couple only camera poses
    and are replicated: their Gauss-Newton terms are added once, after
    the reduction, and their residuals enter the LM accept/reject cost.
    Every rank returns the same result; cost[0] is the pre-optimisation
    cost."""
    ax = mesh.axis(axis)
    n_dev = ax.size
    problem = BaProblem(*(None if x is None else globalize_replicated(mesh, x)
                          for x in problem))
    problem, l_orig = _pad_landmarks(problem, n_dev)
    f, l = problem.mask.shape
    dt, dev = problem.kf_t.dtype, problem.kf_t.device
    odo = None
    if problem.odo_t is not None:
        odo_w = (problem.odo_w if problem.odo_w is not None
                 else torch.ones(f - 1, dtype=dt, device=dev))
        odo = (problem.odo_t, problem.odo_q, odo_weight_t, odo_weight_r,
               odo_w)
    lcp = None
    if problem.lcp_i is not None:
        # the reference's form: unit scalar weights and a [G, 6, 6]
        # square-root information (the scalar weights' diagonal when the
        # problem carries none)
        n_lcp = problem.lcp_i.shape[0]
        info = problem.lcp_info
        if info is None:
            diag = torch.tensor([lcp_weight_t] * 3 + [lcp_weight_r] * 3,
                                dtype=dt)
            info = torch.diag(diag).to(dev)[None].expand(n_lcp, 6, 6)
        lcp = (problem.lcp_i, problem.lcp_j, problem.lcp_t, problem.lcp_q,
               1.0, 1.0,
               problem.lcp_w if problem.lcp_w is not None
               else torch.ones(n_lcp, dtype=dt, device=dev), info)

    obs_xyz = (problem.obs_xyz if problem.obs_xyz is not None
               else torch.zeros((f, l, 3), dtype=dt, device=dev))
    mask_xyz = (problem.mask_xyz if problem.mask_xyz is not None
                else problem.mask)
    w_xyz_fl = _depth_weights(problem.mask & mask_xyz, obs_xyz,
                              depth_weight, depth_range_ref, dt)
    lc = (problem.lc_lm if problem.lc_lm is not None
          else torch.zeros(l, dtype=torch.bool, device=dev))

    # this rank's landmark shard ([F, L/n] and [L/n] tensors)
    def cols(x):
        return shard_batch(mesh, x.transpose(0, 1), axis).transpose(0, 1)

    obs_uv_l, mask_l = cols(problem.obs_uv), cols(problem.mask)
    obs_xyz_l, w_xyz_l = cols(obs_xyz), cols(w_xyz_fl)
    hub_l = torch.where(shard_batch(mesh, lc, axis)[None, :], 1e6, 3.0
                        ).to(dt)
    ar = torch.arange(f, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    keep = torch.ones(f, dtype=dt, device=dev)
    keep[0].fill_(0.0)

    def step(kf_t, kf_q, points_l, lam):
        """One Gauss-Newton step: (dc [F, 6], dp_l [L/n, 3])."""
        hcc, hpp, wcp, bc, bp = _build_normal_eqs(
            cam, kf_t, kf_q, points_l, obs_uv_l, mask_l, obs_xyz_l,
            w_xyz_l, lam, huber_delta=hub_l)
        hpp_inv, _ = torch.linalg.inv_ex(hpp)
        s_local = -torch.einsum("flab,lbc,gldc->fagd", wcp, hpp_inv, wcp)
        s_local[ar, :, ar, :] += hcc
        rhs_local = bc - torch.einsum("flab,lbc,lc->fa", wcp, hpp_inv, bp)
        # one all-reduce of [S | rhs]: every rank holds the full system
        packed = psum(mesh, torch.cat([s_local.reshape(-1),
                                       rhs_local.reshape(-1)]), axis)
        s_full = packed[:f * 6 * f * 6].reshape(f, 6, f, 6)
        rhs_full = packed[f * 6 * f * 6:].reshape(f, 6)
        # the damping was added on every rank: keep one copy
        s_full[ar, :, ar, :] -= (n_dev - 1) * lam * eye6
        # replicated camera-camera factors, once per copy (not summed)
        if odo is not None:
            s_add, rhs_add, _, _ = _odo_terms(kf_t, kf_q, *odo)
            s_full = s_full + s_add
            rhs_full = rhs_full + rhs_add
        if lcp is not None:
            s_lc, rhs_lc, _, _ = _pair_terms(kf_t, kf_q, *lcp)
            s_full = s_full + s_lc
            rhs_full = rhs_full + rhs_lc
        # gauge: freeze keyframe 0
        s_full = s_full * keep[:, None, None, None] * keep[None, None, :, None]
        s_full[0, :, 0, :] = eye6
        rhs_full = rhs_full * keep[:, None]
        sd = s_full.reshape(f * 6, f * 6)
        d = torch.sqrt(torch.clamp(torch.diagonal(sd), min=1e-12))
        sn = sd / d[:, None] / d[None, :]
        y, _ = torch.linalg.solve_ex(sn, rhs_full.reshape(-1) / d)
        dc = (y / d).reshape(f, 6)
        dp_l = torch.einsum("lab,lb->la", hpp_inv,
                            bp - torch.einsum("flab,fa->lb", wcp, dc))
        return dc, dp_l

    def cost(kf_t, kf_q, points_l):
        """Mean factor cost: the shard's landmark-factor sums, all-reduced,
        plus the replicated pose factors."""
        tot, n = _cost_sums(cam, kf_t, kf_q, points_l, obs_uv_l, mask_l,
                            obs_xyz_l, w_xyz_l, huber_delta=hub_l)
        sums = psum(mesh, torch.stack([tot, n.to(dt)]), axis)
        tot, n = sums[0], sums[1]
        if odo is not None:
            ot, on = _odo_cost_sums(kf_t, kf_q, odo)
            tot, n = tot + ot, n + on
        if lcp is not None:
            pt, pn = _pair_cost_sums(kf_t, kf_q, lcp)
            tot, n = tot + pt, n + pn
        return tot / torch.clamp(n, min=1)

    kf_t, kf_q = problem.kf_t, problem.kf_q
    points_l = shard_batch(mesh, problem.points, axis)
    lam = torch.full((), damping, dtype=dt, device=dev)
    costs = [cost(kf_t, kf_q, points_l)]
    for _ in range(iters):
        c0 = costs[-1]
        dc, dp_l = step(kf_t, kf_q, points_l, lam)
        t2 = kf_t + dc[:, :3]
        q2 = qnormalize(qprod(kf_q, v2q(dc[:, 3:])))
        p2 = points_l + dp_l
        c1 = cost(t2, q2, p2)
        better = c1 < c0
        kf_t = torch.where(better, t2, kf_t)
        kf_q = torch.where(better, q2, kf_q)
        points_l = torch.where(better, p2, points_l)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-8),
                          torch.clamp(lam * 10.0, max=1e6))
        costs.append(torch.where(better, c1, c0))
    points = all_gather(mesh, points_l, axis)[:l_orig]
    return BaResult(kf_t=kf_t, kf_q=kf_q, points=points,
                    cost=torch.stack(costs))
