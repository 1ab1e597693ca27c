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
of each ``torch.where``. Nothing is read back to the host. The solve is
a step program whose schedule holds the all-reduces
(``parallel/programs.py``; ``bundle_adjust_sharded``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pre3_tpu_torch.backend.ba import (
    BaProblem, BaResult, _build_normal_eqs, _cost_sums, _depth_weights,
    _odo_cost_sums, _odo_terms, _pair_cost_sums, _pair_terms,
)
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.quaternion import qnormalize, qprod, v2q
from pre3_tpu_torch.parallel.distributed import globalize_replicated
from pre3_tpu_torch.parallel.mesh import (
    Mesh, all_gather, psum_, shard_batch,
)
from pre3_tpu_torch.parallel.programs import (
    Collective, MeshProgram, Segment, fuses,
)
from pre3_tpu_torch.utils.device import cached_constant
from pre3_tpu_torch.utils.graphs import (
    empty_like_tree, keep, load, program, shape_key,
)


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


class _Shard(NamedTuple):
    """This rank's share of a problem, loaded into the program once per
    solve: the landmark shard's observations with their defaults and
    weights filled in, the replicated pose factors and the initial
    iterate."""

    obs_uv: torch.Tensor  # [F, L/n, 2]
    mask: torch.Tensor  # [F, L/n]
    obs_xyz: torch.Tensor  # [F, L/n, 3]
    w_xyz: torch.Tensor  # [F, L/n] depth-factor weights
    hub: torch.Tensor  # [1, L/n] Huber δ
    odo: tuple | None  # (odo_t, odo_q, odo_w)
    lcp: tuple | None  # (i, j, rel_t, rel_q, w, info)
    kf_t: torch.Tensor  # [F, 3]
    kf_q: torch.Tensor  # [F, 4]
    points: torch.Tensor  # [L/n, 3]


def _shard(mesh: Mesh, problem: BaProblem, axis: str, depth_weight: float,
           depth_range_ref: float, lcp_weight_t: float,
           lcp_weight_r: float) -> _Shard:
    """The per-solve set-up of a padded problem: this rank's ``_Shard``."""
    f, l = problem.mask.shape
    dt, dev = problem.kf_t.dtype, problem.kf_t.device
    odo = None
    if problem.odo_t is not None:
        odo = (problem.odo_t, problem.odo_q,
               problem.odo_w if problem.odo_w is not None
               else torch.ones(f - 1, dtype=dt, device=dev))
    lcp = None
    if problem.lcp_i is not None:
        # the reference's form: unit scalar weights and a [G, 6, 6]
        # square-root information (the scalar weights' diagonal when the
        # problem carries none)
        n_lcp = problem.lcp_i.shape[0]
        info = problem.lcp_info
        if info is None:
            info = cached_constant(
                ("lcp_info", lcp_weight_t, lcp_weight_r, dt),
                lambda: torch.diag(torch.tensor(
                    [lcp_weight_t] * 3 + [lcp_weight_r] * 3, dtype=dt)),
                dev)[None].expand(n_lcp, 6, 6)
        lcp = (problem.lcp_i, problem.lcp_j, problem.lcp_t, problem.lcp_q,
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

    def cols(x):  # this rank's landmark columns ([F, L/n, ...])
        return shard_batch(mesh, x.transpose(0, 1), axis).transpose(0, 1)

    return _Shard(
        cols(problem.obs_uv), cols(problem.mask), cols(obs_xyz),
        cols(w_xyz_fl),
        torch.where(shard_batch(mesh, lc, axis)[None, :], 1e6, 3.0).to(dt),
        odo, lcp, problem.kf_t, problem.kf_q,
        shard_batch(mesh, problem.points, axis))


def _constants(f: int, dt, dev) -> tuple:
    """(arange(F), eye(6), the gauge row: 0 for keyframe 0, else 1), built
    once per device."""
    def gauge():
        g = torch.ones(f, dtype=dt)
        g[0] = 0.0
        return g

    return (cached_constant(("ba_sharded.arange", f),
                            lambda: torch.arange(f), dev),
            cached_constant(("ba_sharded.eye6", dt),
                            lambda: torch.eye(6, dtype=dt), dev),
            cached_constant(("ba_sharded.gauge", f, dt), gauge, dev))


def _schedules(mesh: Mesh, cam: Camera, axis: str, odo_weight_t: float,
               odo_weight_r: float) -> dict:
    """The solve's two variants as schedules (``parallel/programs.py``)
    over the buffers: ``problem`` (a ``_Shard``), the carry (kf_t, kf_q,
    points_l, lam, c0) and what the segments hand each other. ``cost0``
    puts the initial iterate and its cost into the carry (λ is the
    caller's fill); ``iteration`` is one LM step. Per iteration two
    all-reduces: [S | rhs] and the cost sums."""
    n_dev = mesh.axis(axis).size

    def pose_terms(sh: _Shard):
        odo = None if sh.odo is None else (
            sh.odo[0], sh.odo[1], odo_weight_t, odo_weight_r, sh.odo[2])
        lcp = None if sh.lcp is None else (*sh.lcp[:4], 1.0, 1.0,
                                           *sh.lcp[4:])
        return odo, lcp

    def local_sums(sh, kf_t, kf_q, points_l):
        """The shard's landmark-factor cost sums, [Σ, count]."""
        tot, n = _cost_sums(cam, kf_t, kf_q, points_l, sh.obs_uv, sh.mask,
                            sh.obs_xyz, sh.w_xyz, huber_delta=sh.hub)
        return torch.stack([tot, n.to(kf_t.dtype)])

    def mean_cost(sh, sums, kf_t, kf_q):
        """Mean factor cost from the all-reduced sums plus the replicated
        pose factors."""
        odo, lcp = pose_terms(sh)
        tot, n = sums[0], sums[1]
        if odo is not None:
            ot, on = _odo_cost_sums(kf_t, kf_q, odo)
            tot, n = tot + ot, n + on
        if lcp is not None:
            pt, pn = _pair_cost_sums(kf_t, kf_q, lcp)
            tot, n = tot + pt, n + pn
        return tot / torch.clamp(n, min=1)

    def cost0_sums(b):
        sh = b["problem"]
        load((b["kf_t"], b["kf_q"], b["points"]),
             (sh.kf_t, sh.kf_q, sh.points))
        keep(b, "sums", local_sums(sh, b["kf_t"], b["kf_q"], b["points"]))

    def cost0(b):
        b["c0"].copy_(mean_cost(b["problem"], b["sums"], b["kf_t"],
                                b["kf_q"]))

    def linearize(b):
        """The shard's Schur-reduced camera system, packed [S | rhs]."""
        sh, kf_t, kf_q, lam = b["problem"], b["kf_t"], b["kf_q"], b["lam"]
        f = kf_t.shape[0]
        hcc, hpp, wcp, bc, bp = _build_normal_eqs(
            cam, kf_t, kf_q, b["points"], sh.obs_uv, sh.mask, sh.obs_xyz,
            sh.w_xyz, lam, huber_delta=sh.hub)
        hpp_inv, _ = torch.linalg.inv_ex(hpp)
        s_local = -torch.einsum("flab,lbc,gldc->fagd", wcp, hpp_inv, wcp)
        ar, _, _ = _constants(f, kf_t.dtype, kf_t.device)
        s_local[ar, :, ar, :] += hcc
        rhs_local = bc - torch.einsum("flab,lbc,lc->fa", wcp, hpp_inv, bp)
        keep(b, "packed", torch.cat([s_local.reshape(-1),
                                     rhs_local.reshape(-1)]))
        keep(b, "back", (hpp_inv, wcp, bp))

    def solve(b):
        """The summed system solved (every rank the same), the landmarks
        back-substituted, the trial iterate's local cost sums."""
        sh, kf_t, kf_q, lam = b["problem"], b["kf_t"], b["kf_q"], b["lam"]
        f = kf_t.shape[0]
        dt, dev = kf_t.dtype, kf_t.device
        odo, lcp = pose_terms(sh)
        ar, eye6, keep0 = _constants(f, dt, dev)
        packed = b["packed"]
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
        s_full = (s_full * keep0[:, None, None, None]
                  * keep0[None, None, :, None])
        s_full[0, :, 0, :] = eye6
        rhs_full = rhs_full * keep0[:, None]
        sd = s_full.reshape(f * 6, f * 6)
        d = torch.sqrt(torch.clamp(torch.diagonal(sd), min=1e-12))
        sn = sd / d[:, None] / d[None, :]
        y, _ = torch.linalg.solve_ex(sn, rhs_full.reshape(-1) / d)
        dc = (y / d).reshape(f, 6)
        hpp_inv, wcp, bp = b["back"]
        dp_l = torch.einsum("lab,lb->la", hpp_inv,
                            bp - torch.einsum("flab,fa->lb", wcp, dc))
        t2 = kf_t + dc[:, :3]
        q2 = qnormalize(qprod(kf_q, v2q(dc[:, 3:])))
        p2 = b["points"] + dp_l
        keep(b, "trial", (t2, q2, p2))
        keep(b, "sums", local_sums(sh, t2, q2, p2))

    def select(b):
        """Keep the trial iterate if it lowers the cost; λ follows."""
        t2, q2, p2 = b["trial"]
        c0, lam = b["c0"], b["lam"]
        c1 = mean_cost(b["problem"], b["sums"], t2, q2)
        better = c1 < c0
        load((b["kf_t"], b["kf_q"], b["points"], lam, c0), (
            torch.where(better, t2, b["kf_t"]),
            torch.where(better, q2, b["kf_q"]),
            torch.where(better, p2, b["points"]),
            torch.where(better, torch.clamp(lam * 0.5, min=1e-8),
                        torch.clamp(lam * 10.0, max=1e6)),
            torch.where(better, c1, c0)))

    def reduce(name):
        return Collective(lambda b: psum_(mesh, b[name], axis))

    return {
        "cost0": [Segment("cost0_sums", cost0_sums), reduce("sums"),
                  Segment("cost0", cost0)],
        "iteration": [Segment("linearize", linearize), reduce("packed"),
                      Segment("solve", solve), reduce("sums"),
                      Segment("select", select)],
    }


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
    cost.

    The reference jits the solve whole. Here it is a ``MeshProgram``
    (``parallel/programs.py``) with the variants ``cost0`` and
    ``iteration``, keyed by the shard's shapes, the camera, the
    odometry weights and the mesh axis, never by ``iters``: the shard is
    set up and copied into the program once per solve, then one run of
    ``cost0`` and ``iters`` of ``iteration`` update the carry in place.
    At one rank each run is one graph replay, the all-reduces inside;
    across ranks each segment between them is."""
    ax = mesh.axis(axis)
    problem = BaProblem(*(None if x is None else globalize_replicated(mesh, x)
                          for x in problem))
    problem, l_orig = _pad_landmarks(problem, ax.size)
    dt, dev = problem.kf_t.dtype, problem.kf_t.device
    shard = _shard(mesh, problem, axis, depth_weight, depth_range_ref,
                   lcp_weight_t, lcp_weight_r)
    fused = fuses(mesh, axis)

    def make():
        scalar = torch.empty((), dtype=dt, device=dev)
        bufs = dict(problem=empty_like_tree(shard),
                    kf_t=torch.empty_like(shard.kf_t),
                    kf_q=torch.empty_like(shard.kf_q),
                    points=torch.empty_like(shard.points),
                    lam=scalar, c0=torch.empty_like(scalar))
        return MeshProgram("bundle_adjust_sharded", bufs, dev, fused)

    prog = program(("bundle_adjust_sharded", cam, odo_weight_t, odo_weight_r,
                    fused, ax.size, ax.rank, ax.group, shape_key(shard)),
                   make)
    b = prog.buffers
    load(b["problem"], shard)
    b["lam"].fill_(damping)
    schedules = _schedules(mesh, cam, axis, odo_weight_t, odo_weight_r)
    cost = torch.empty(iters + 1, dtype=dt, device=dev)
    for i, variant in enumerate(["cost0"] + ["iteration"] * iters):
        prog.run_schedule(mesh, variant, schedules[variant])
        cost[i].copy_(b["c0"])
    points = all_gather(mesh, b["points"], axis)[:l_orig]
    if ax.group is None:  # one process: the gather is the buffer itself
        points = points.clone()
    return BaResult(kf_t=b["kf_t"].clone(), kf_q=b["kf_q"].clone(),
                    points=points, cost=cost)
