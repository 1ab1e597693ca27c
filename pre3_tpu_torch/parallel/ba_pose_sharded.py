"""Pose-sharded (keyframe-block) distributed bundle adjustment.

Port of ``pre3_tpu/parallel/ba_pose_sharded.py``. parallel/ba_sharded.py
shards the landmark axis and replicates every pose: each Gauss-Newton
iteration all-reduces the dense [6F, 6F] reduced camera system, which
grows as F². Here the trajectory is partitioned into contiguous keyframe
blocks, one per rank:

  * each block owns its poses and the landmarks whose observation span
    falls inside its window (own poses ± ``sep`` separator poses on each
    side); a landmark no window covers joins a replicated global factor
    group (see ``_partition``), so no observation is ever dropped;
  * linearization and the landmark Schur elimination are block-local; the
    reduced camera system exists only as per-block [W·6, W·6] window
    operators whose overlaps tile a block-banded global matrix;
  * the step solves that system with distributed block-Jacobi
    preconditioned conjugate gradients at a fixed trip count: each matvec
    is one window-operator product plus a halo exchange of the separator
    poses with the two ring neighbours (``ppermute``: two slabs out, two
    back, each [sep, 6]), and each dot product is one scalar all-reduce.
    There is no early exit, so nothing is read back to the host; the ring
    keeps its wraparound, and ``win_valid`` masks the chain's ends;
  * the global-landmark group and the loop-closure pose factors ride an
    all-gathered pose vector [Fpad, 6];
  * landmark back-substitution is block-local.

Same LM damping schedule and factor set as backend.ba.bundle_adjust, so on
any problem the two agree to CG tolerance. The partition and the
un-partition back to global indices are host numpy. The solve is a step
program whose schedule holds the collectives (``parallel/programs.py``;
``bundle_adjust_pose_sharded``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pre3_tpu_torch.backend.ba import (
    BaProblem, BaResult, _build_normal_eqs, _cost_sums, _odo_cost_sums,
    _odo_terms, _pair_residual_jacobians,
)
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.quaternion import qnormalize, qprod, v2q
from pre3_tpu_torch.parallel.distributed import globalize_replicated
from pre3_tpu_torch.parallel.mesh import (
    Mesh, all_gather, ppermute, psum_,
)
from pre3_tpu_torch.parallel.programs import (
    Collective, MeshProgram, Segment, fuses,
)
from pre3_tpu_torch.utils.device import cached_constant
from pre3_tpu_torch.utils.graphs import (
    empty_like_tree, keep, load, program, shape_key,
)


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def _partition(problem: BaProblem, n_dev: int, sep: int):
    """Host-side block partition of a BaProblem (numpy arrays; shapes
    depend on the data). Returns per-block arrays with leading axis n_dev,
    a replicated GLOBAL-landmark group, and a report dict.

    Landmark routing (no observation is ever dropped):
      * a landmark whose observation span fits inside SOME block's window
        [b·fb − sep, b·fb + fb + sep) is LOCAL to that block (the covering
        block nearest its median observing keyframe),
      * a landmark no window covers (a long-baseline track, a loop-closure
        re-observation) is GLOBAL: its factors are replicated on every
        rank and enter the distributed solve through an all-gather of the
        pose iterate.
    """
    f, l = problem.mask.shape
    fb = (f + n_dev - 1) // n_dev  # owned poses per block
    fpad = fb * n_dev
    w = fb + 2 * sep  # window width

    mask = np.asarray(problem.mask)
    obs_uv = np.asarray(problem.obs_uv)
    obs_xyz = (
        np.asarray(problem.obs_xyz)
        if problem.obs_xyz is not None
        else np.zeros((f, l, 3), np.float32)
    )
    mask_xyz = (
        np.asarray(problem.mask_xyz)
        if problem.mask_xyz is not None else mask
    )
    lc = (
        np.asarray(problem.lc_lm)
        if problem.lc_lm is not None else np.zeros(l, bool)
    )

    # landmark home block: the window-covering block nearest the median
    # observing keyframe; no covering window → global
    obs_any = mask.any(axis=0)
    home = np.full(l, -1)  # -1 = global
    for j in range(l):
        if not obs_any[j]:
            continue
        rows = np.nonzero(mask[:, j])[0]
        med = int(np.median(rows))
        # block b covers [b*fb - sep, b*fb + fb + sep)
        b_hi = (rows[0] + sep) // fb
        b_lo = -((-(rows[-1] + 1 - fb - sep)) // fb)  # ceil division
        b_lo, b_hi = max(b_lo, 0), min(b_hi, n_dev - 1)
        if b_lo <= b_hi:
            home[j] = min(max(med // fb, b_lo), b_hi)

    # window pose range per block (global indices, clipped mask)
    win_lo = np.array([b * fb - sep for b in range(n_dev)])
    # per-block landmark lists, padded to a common Lb
    blocks = [np.nonzero(obs_any & (home == b))[0] for b in range(n_dev)]
    lb = max(1, max(len(bl) for bl in blocks))

    b_uv = np.zeros((n_dev, w, lb, 2), np.float32)
    b_xyz = np.zeros((n_dev, w, lb, 3), np.float32)
    b_mask = np.zeros((n_dev, w, lb), bool)
    b_mask_xyz = np.zeros((n_dev, w, lb), bool)
    b_lc = np.zeros((n_dev, lb), bool)
    b_lidx = np.zeros((n_dev, lb), np.int64)  # global landmark index
    b_lvalid = np.zeros((n_dev, lb), bool)
    dropped = 0
    total_obs = int(mask.sum())
    for b in range(n_dev):
        lo = win_lo[b]
        for jj, j in enumerate(blocks[b]):
            b_lidx[b, jj] = j
            b_lvalid[b, jj] = True
            b_lc[b, jj] = lc[j]
            rows = np.nonzero(mask[:, j])[0]
            for r in rows:
                wi = r - lo
                if 0 <= wi < w and r < f:
                    b_uv[b, wi, jj] = obs_uv[r, j]
                    b_xyz[b, wi, jj] = obs_xyz[r, j]
                    b_mask[b, wi, jj] = True
                    b_mask_xyz[b, wi, jj] = mask_xyz[r, j]
                else:  # unreachable by construction of `home`
                    dropped += 1

    # --- global landmarks: replicated factor group over all fpad poses ---
    glms = np.nonzero(obs_any & (home < 0))[0]
    lg = max(1, len(glms))
    g_uv = np.zeros((fpad, lg, 2), np.float32)
    g_xyz = np.zeros((fpad, lg, 3), np.float32)
    g_mask = np.zeros((fpad, lg), bool)
    g_mask_xyz = np.zeros((fpad, lg), bool)
    g_lc = np.zeros(lg, bool)
    g_lidx = np.zeros(lg, np.int64)
    g_lvalid = np.zeros(lg, bool)
    for jj, j in enumerate(glms):
        g_lidx[jj] = j
        g_lvalid[jj] = True
        g_lc[jj] = lc[j]
        g_uv[:f, jj] = obs_uv[:, j]
        g_xyz[:f, jj] = obs_xyz[:, j]
        g_mask[:f, jj] = mask[:, j]
        g_mask_xyz[:f, jj] = mask_xyz[:, j]

    # odometry-chain factors: factor i (pose i → i+1) owned by the block
    # owning pose i; window positions (i−lo, i−lo+1) — inside the window
    # for sep ≥ 1 even at the block boundary
    odo_t = (
        np.asarray(problem.odo_t)
        if problem.odo_t is not None else np.zeros((0, 3), np.float32)
    )
    odo_q = (
        np.asarray(problem.odo_q)
        if problem.odo_q is not None
        else np.zeros((0, 4), np.float32)
    )
    odo_w = (
        np.asarray(problem.odo_w)
        if problem.odo_w is not None
        else np.ones(len(odo_t), np.float32)
    )
    b_odo_t = np.zeros((n_dev, fb, 3), np.float32)
    b_odo_q = np.tile(
        np.array([1.0, 0, 0, 0], np.float32), (n_dev, fb, 1)
    )
    b_odo_w = np.zeros((n_dev, fb), np.float32)
    for i in range(min(len(odo_t), f - 1)):
        b = i // fb
        b_odo_t[b, i - b * fb] = odo_t[i]
        b_odo_q[b, i - b * fb] = odo_q[i]
        b_odo_w[b, i - b * fb] = odo_w[i]

    # initial poses, padded; per-block window validity / ownership masks
    kf_t = np.zeros((fpad, 3), np.float32)
    kf_t[:f] = np.asarray(problem.kf_t)
    kf_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (fpad, 1))
    kf_q[:f] = np.asarray(problem.kf_q)
    # padded landmark slots sit at a safe z=2 point: a (0,0,0) pad would
    # project as 0/0 → NaN, and NaN·0 mask products poison the whole block
    points = np.tile(np.array([0.0, 0, 2.0], np.float32), (n_dev, lb, 1))
    pall = np.asarray(problem.points)
    for b in range(n_dev):
        for jj, j in enumerate(blocks[b]):
            points[b, jj] = pall[j]
    g_points = np.tile(np.array([0.0, 0, 2.0], np.float32), (lg, 1))
    for jj, j in enumerate(glms):
        g_points[jj] = pall[j]

    win_valid = np.zeros((n_dev, w), bool)
    for b in range(n_dev):
        gi = win_lo[b] + np.arange(w)
        win_valid[b] = (gi >= 0) & (gi < f)

    report = {"dropped_obs": dropped, "total_obs": total_obs,
              "blocks_lb": lb, "window": w, "fb": fb,
              "global_lm": int(len(glms)),
              "global_obs": int(g_mask.sum())}
    return (
        dict(
            b_uv=b_uv, b_xyz=b_xyz, b_mask=b_mask, b_mask_xyz=b_mask_xyz,
            b_lc=b_lc, b_lidx=b_lidx, b_lvalid=b_lvalid,
            b_odo_t=b_odo_t, b_odo_q=b_odo_q, b_odo_w=b_odo_w,
            kf_t=kf_t.reshape(n_dev, fb, 3),
            kf_q=kf_q.reshape(n_dev, fb, 4),
            points=points, win_valid=win_valid,
            g_uv=g_uv, g_xyz=g_xyz, g_mask=g_mask,
            g_mask_xyz=g_mask_xyz, g_lc=g_lc, g_lidx=g_lidx,
            g_lvalid=g_lvalid, g_points=g_points,
            n_global=len(glms),
        ),
        report,
    )


class _Block(NamedTuple):
    """This rank's keyframe block, loaded into the program once per
    solve: the window's landmark factors with their weights, the
    block's odometry factors, the masks of the window and of the owned
    poses, and the replicated global-landmark and loop-closure groups
    (None where the problem has none)."""

    b_uv: torch.Tensor  # [W, Lb, 2]
    b_xyz: torch.Tensor  # [W, Lb, 3]
    b_mask: torch.Tensor  # [W, Lb]
    w_xyz: torch.Tensor  # [W, Lb]
    hub: torch.Tensor  # [1, Lb]
    b_odo: tuple  # (odo_t [Fb, 3], odo_q [Fb, 4], odo_w [Fb])
    win_valid: torch.Tensor  # [W] bool
    keep_own: torch.Tensor  # [Fb]: owned pose takes part
    keep_win: torch.Tensor  # [W]
    keep_glob: torch.Tensor | None  # [Fpad]
    glob: tuple | None  # (g_uv, g_xyz, g_mask, g_wxyz, g_hub)
    lcp: tuple | None  # (i, j, rel_t, rel_q, w, info)


def _schedules(mesh: Mesh, cam: Camera, axis: str, sep: int, fb: int,
               cg_iters: int, odo_weight_t: float,
               odo_weight_r: float, has_global: bool,
               has_lcp: bool) -> dict:
    """The solve's two variants as schedules (``parallel/programs.py``)
    over the buffers: ``problem`` (a ``_Block``), the carry (t_own,
    q_own, pts, pts_g, lam, c0) and what the segments hand each other.
    Every collective is the eager solve's: a halo exchange is two
    ``ppermute`` slabs out of a buffer's ends, a halo reduce two into
    the owned rows, a pose gather one all-gather, a dot product one
    scalar all-reduce."""
    n_dev = mesh.axis(axis).size
    need_glob = has_global or has_lcp
    ring_right, ring_left = _rings(n_dev)
    f32 = torch.float32

    def exchange(name):
        return _exchange(mesh, axis, sep, name)

    def reduce_halo(name):
        """[W, ...] window contributions → the neighbours' contributions
        to my boundary poses (``owned``)."""
        return [_pp(mesh, axis, name + "_tl", lambda b: b[name][:sep],
                    ring_left),
                _pp(mesh, axis, name + "_tr", lambda b: b[name][-sep:],
                    ring_right)]

    def owned(b, name):  # [Fb, ...]: my slice plus the neighbours' sums
        out = b[name][sep:sep + fb].clone()
        out[-sep:] += b[name + "_tl"]
        out[:sep] += b[name + "_tr"]
        return out

    def gather(name):  # [Fb, ...] → [Fpad, ...]
        return Collective(lambda b: keep(b, name + "_glob",
                                         all_gather(mesh, b[name], axis)))

    def reduce(name):
        return Collective(lambda b: psum_(mesh, b[name], axis))

    def own_rows(b, x_glob):  # [Fpad, ...] → this block's [Fb, ...]
        r = mesh.axis(axis).rank
        return x_glob[r * fb:(r + 1) * fb]

    def poses(name_t, name_q):
        """The collectives a pose pair's windows and gathers take."""
        out = exchange(name_t) + exchange(name_q)
        if need_glob:
            out += [gather(name_t), gather(name_q)]
        return out

    def block_sums(b, name_t, name_q, pts, pts_g):
        """This block's share of the factor cost sums, [Σ, count]: its
        window's factors and odometry, and 1/n of the replicated global
        and loop-closure groups, so that the all-reduce counts them
        once."""
        pb = b["problem"]
        wv = pb.win_valid[:, None]
        t_win, q_win = _window(b, name_t), _window(b, name_q)
        tot, n = _cost_sums(cam, t_win, q_win, pts, pb.b_uv, pb.b_mask & wv,
                            pb.b_xyz, pb.w_xyz * wv.to(f32),
                            huber_delta=pb.hub)
        o = slice(sep, sep + fb + 1)
        ot, on = _odo_cost_sums(t_win[o], q_win[o], odo(pb))
        tot, n = tot + ot, (n + on).to(f32)
        if need_glob:
            t_glob, q_glob = b[name_t + "_glob"], b[name_q + "_glob"]
        if has_global:
            g_uv, g_xyz, g_mask, g_wxyz, g_hub = pb.glob
            gt, gn = _cost_sums(cam, t_glob, q_glob, pts_g, g_uv, g_mask,
                                g_xyz, g_wxyz, huber_delta=g_hub)
            tot, n = tot + gt / n_dev, n + gn / n_dev
        if has_lcp:
            r_p, _, _ = _pair_residual_jacobians(t_glob, q_glob, *lcp(pb))
            tot = tot + torch.sum(r_p * r_p) / n_dev
            n = n + torch.sum(pb.lcp[4] > 0) / n_dev
        keep(b, "sums", torch.stack([tot, n]))

    def mean_cost(b):
        return b["sums"][0] / torch.clamp(b["sums"][1], min=1)

    def odo(pb):
        return (pb.b_odo[0], pb.b_odo[1], odo_weight_t, odo_weight_r,
                pb.b_odo[2])

    def lcp(pb):
        return (*pb.lcp[:4], 1.0, 1.0, *pb.lcp[4:])

    def cost0_sums(b):
        block_sums(b, "t_own", "q_own", b["pts"], b["pts_g"])

    def cost0(b):
        b["c0"].copy_(mean_cost(b))

    def linearize(b):
        """The window's landmark Schur complement and the block's
        odometry terms (the window operator S_b and its rhs), the
        replicated global group's and loop-closure factors' terms."""
        pb, lam = b["problem"], b["lam"]
        ar_w = _arange(pb.win_valid.shape[0], lam.device)
        eye6 = _eye6(lam.device)
        t_win, q_win = _window(b, "t_own"), _window(b, "q_own")
        wv = pb.win_valid[:, None]
        hcc, hpp, wcp, bc, bp = _build_normal_eqs(
            cam, t_win, q_win, b["pts"], pb.b_uv, pb.b_mask & wv, pb.b_xyz,
            pb.w_xyz * wv.to(f32), lam, huber_delta=pb.hub)
        hpp_inv, _ = torch.linalg.inv_ex(hpp)
        # window operator S_b = diag(hcc) − W Hpp⁻¹ Wᵀ  [W, 6, W, 6]
        s_win = -torch.einsum("flab,lbc,gldc->fagd", wcp, hpp_inv, wcp)
        s_win[ar_w, :, ar_w, :] += hcc
        rhs_win = bc - torch.einsum("flab,lbc,lc->fa", wcp, hpp_inv, bp)
        # the block's odometry factors on window poses [sep, sep + fb]
        o = slice(sep, sep + fb + 1)
        s_add, rhs_add, _, _ = _odo_terms(t_win[o], q_win[o], *odo(pb))
        s_win[o, :, o, :] += s_add
        rhs_win[o] += rhs_add
        # gauge + validity: zero the rows and columns of frozen and
        # padded poses; win_valid also kills the ring's wraparound halos
        # at the chain's ends
        kw = pb.keep_win
        s_win = s_win * kw[:, None, None, None] * kw[None, None, :, None]
        keep(b, "s_win", s_win)
        keep(b, "rhs_win", rhs_win * kw[:, None])
        keep(b, "diag_win", s_win[ar_w, :, ar_w, :])
        keep(b, "back", (hpp_inv, wcp, bp))
        if need_glob:
            t_glob, q_glob = b["t_own_glob"], b["q_own_glob"]
        if has_global:
            # replicated linearization of the global-landmark group over
            # the gathered poses [Fpad, ...]: identical on every rank
            g_uv, g_xyz, g_mask, g_wxyz, g_hub = pb.glob
            hcc_g, hpp_g, wcp_g, bc_g, bp_g = _build_normal_eqs(
                cam, t_glob, q_glob, b["pts_g"], g_uv, g_mask, g_xyz, g_wxyz,
                lam, huber_delta=g_hub)
            # λ is already on every pose's diagonal from the window
            # linearization: drop the duplicate
            hcc_g = hcc_g - lam * eye6[None]
            hpp_g_inv, _ = torch.linalg.inv_ex(hpp_g)
            rhs_g = (bc_g - torch.einsum("flab,lbc,lc->fa", wcp_g, hpp_g_inv,
                                         bp_g)) * pb.keep_glob[:, None]
            diag_g = hcc_g - torch.einsum("flab,lbc,fldc->fad", wcp_g,
                                          hpp_g_inv, wcp_g)
            keep(b, "global", (hcc_g, hpp_g_inv, wcp_g, bp_g, rhs_g, diag_g))
        if has_lcp:
            # keyframe-pair factors, linearized replicated on the gathered
            # poses; their action enters the matvec factored (Jᵀ(Jx))
            i_p, j_p = pb.lcp[0], pb.lcp[1]
            r_p, ji_p, jj_p = _pair_residual_jacobians(t_glob, q_glob,
                                                       *lcp(pb))
            fpad = t_glob.shape[0]
            rhs_p = torch.zeros((fpad, 6), dtype=f32, device=lam.device)
            rhs_p.index_add_(0, i_p, -torch.einsum("pab,pa->pb", ji_p, r_p))
            rhs_p.index_add_(0, j_p, -torch.einsum("pab,pa->pb", jj_p, r_p))
            diag_p = torch.zeros((fpad, 6, 6), dtype=f32, device=lam.device)
            diag_p.index_add_(0, i_p, torch.einsum("pab,pac->pbc", ji_p,
                                                   ji_p))
            diag_p.index_add_(0, j_p, torch.einsum("pab,pac->pbc", jj_p,
                                                   jj_p))
            keep(b, "pair", (ji_p, jj_p, rhs_p, diag_p))

    def pcg_init(b):
        """The distributed rhs and Jacobi blocks, the preconditioner and
        the PCG state at x = 0; this rank's share of r·z."""
        pb = b["problem"]
        ko = pb.keep_own
        eye6 = _eye6(ko.device)
        rhs_own, diag_own = owned(b, "rhs_win"), owned(b, "diag_win")
        if has_global:
            rhs_g, diag_g = b["global"][4:]
            rhs_own = rhs_own + own_rows(b, rhs_g)
            diag_own = diag_own + own_rows(b, diag_g) * ko[:, None, None]
        if has_lcp:
            rhs_p, diag_p = b["pair"][2:]
            rhs_own = rhs_own + own_rows(b, rhs_p * pb.keep_glob[:, None])
            diag_own = diag_own + own_rows(b, diag_p) * ko[:, None, None]
        prec, _ = torch.linalg.inv_ex(
            diag_own + 1e-8 * eye6[None]
            + (1.0 - ko)[:, None, None] * eye6[None])  # frozen: I
        keep(b, "prec", prec)
        # block-Jacobi PCG, fixed trip count: no host read, no early exit
        keep(b, "x", torch.zeros((fb, 6), dtype=f32, device=ko.device))
        r = keep(b, "r", rhs_own * ko[:, None])
        z = keep(b, "z", torch.einsum("fab,fb->fa", prec, r))
        keep(b, "p", z)
        keep(b, "rz", torch.sum(r * z))
        keep(b, "xk", z * ko[:, None])

    def matvec(b):
        """The window operator's product with the exchanged p, and the
        replicated groups' parts of S·p."""
        pb = b["problem"]
        keep(b, "y_win", torch.einsum("fagb,gb->fa", b["s_win"],
                                      _window(b, "xk")))
        if need_glob:
            kg = pb.keep_glob[:, None]
            x_glob = b["xk_glob"] * kg  # [Fpad, 6]
        if has_global:
            hcc_g, hpp_g_inv, wcp_g = b["global"][:3]
            u = torch.einsum("flab,fa->lb", wcp_g, x_glob)
            v = torch.einsum("lab,lb->la", hpp_g_inv, u)
            y_g = (torch.einsum("fab,fb->fa", hcc_g, x_glob)
                   - torch.einsum("flab,lb->fa", wcp_g, v))
            keep(b, "y_g", own_rows(b, y_g * kg))
        if has_lcp:
            ji_p, jj_p = b["pair"][:2]
            i_p, j_p = pb.lcp[0], pb.lcp[1]
            jx = (torch.einsum("pab,pb->pa", ji_p, x_glob[i_p])
                  + torch.einsum("pab,pb->pa", jj_p, x_glob[j_p]))
            y_p = torch.zeros_like(x_glob)
            y_p.index_add_(0, i_p, torch.einsum("pab,pa->pb", ji_p, jx))
            y_p.index_add_(0, j_p, torch.einsum("pab,pa->pb", jj_p, jx))
            keep(b, "y_p", own_rows(b, y_p * kg))

    def cg_alpha(b):
        """S·p summed into the owned rows; this rank's share of p·Sp."""
        y = owned(b, "y_win")
        if has_global:
            y = y + b["y_g"]
        if has_lcp:
            y = y + b["y_p"]
        ap = keep(b, "ap", y * b["problem"].keep_own[:, None])
        keep(b, "pap", torch.sum(b["p"] * ap))

    def cg_update(b):
        p, ap = b["p"], b["ap"]
        alpha = b["rz"] / torch.clamp(b["pap"], min=1e-30)
        b["x"].copy_(b["x"] + alpha * p)
        r = b["r"].copy_(b["r"] - alpha * ap)
        z = b["z"].copy_(torch.einsum("fab,fb->fa", b["prec"], r))
        keep(b, "rz_new", torch.sum(r * z))

    def cg_beta(b):
        z, p = b["z"], b["p"]
        beta = b["rz_new"] / torch.clamp(b["rz"], min=1e-30)
        p.copy_(z + beta * p)
        b["rz"].copy_(b["rz_new"])
        b["xk"].copy_(p * b["problem"].keep_own[:, None])

    def trial(b):
        """Landmark back-substitution (block-local; the global group
        replicated) and the trial iterate."""
        x = b["x"]
        hpp_inv, wcp, bp = b["back"]
        dp = torch.einsum("lab,lb->la", hpp_inv,
                          bp - torch.einsum("flab,fa->lb", wcp,
                                            _window(b, "x")))
        if has_global:
            hpp_g_inv, wcp_g, bp_g = b["global"][1:4]
            dp_g = torch.einsum(
                "lab,lb->la", hpp_g_inv,
                bp_g - torch.einsum("flab,fa->lb", wcp_g, b["x_glob"]))
        else:
            dp_g = torch.zeros_like(b["pts_g"])
        keep(b, "t2", b["t_own"] + x[:, :3])
        keep(b, "q2", qnormalize(qprod(b["q_own"], v2q(x[:, 3:]))))
        keep(b, "p2", (b["pts"] + dp, b["pts_g"] + dp_g))

    def trial_sums(b):
        block_sums(b, "t2", "q2", *b["p2"])

    def select(b):
        """Keep the trial iterate if it lowers the cost; λ follows."""
        c0, lam = b["c0"], b["lam"]
        c1 = mean_cost(b)
        better = c1 < c0
        p2, p2_g = b["p2"]
        load((b["t_own"], b["q_own"], b["pts"], b["pts_g"], lam, c0), (
            torch.where(better, b["t2"], b["t_own"]),
            torch.where(better, b["q2"], b["q_own"]),
            torch.where(better, p2, b["pts"]),
            torch.where(better, p2_g, b["pts_g"]),
            torch.where(better, torch.clamp(lam * 0.5, min=1e-8),
                        torch.clamp(lam * 10.0, max=1e6)),
            torch.where(better, c1, c0)))

    pcg = []
    for _ in range(cg_iters):
        pcg += (exchange("xk") + ([gather("xk")] if need_glob else [])
                + [Segment("matvec", matvec)] + reduce_halo("y_win")
                + [Segment("cg_alpha", cg_alpha), reduce("pap"),
                   Segment("cg_update", cg_update), reduce("rz_new"),
                   Segment("cg_beta", cg_beta)])
    return {
        "cost0": poses("t_own", "q_own") + [
            Segment("cost0_sums", cost0_sums), reduce("sums"),
            Segment("cost0", cost0)],
        "iteration": poses("t_own", "q_own") + [
            Segment("linearize", linearize)]
        + reduce_halo("rhs_win") + reduce_halo("diag_win") + [
            Segment("pcg_init", pcg_init), reduce("rz")] + pcg
        + exchange("x")
        + ([gather("x")] if has_global else []) + [
            Segment("trial", trial)] + poses("t2", "q2") + [
            Segment("trial_sums", trial_sums), reduce("sums"),
            Segment("select", select)],
    }


def _rings(n_dev: int) -> tuple[list, list]:
    """The ring's permutations: each block to its right neighbour, and
    to its left."""
    return ([(i, (i + 1) % n_dev) for i in range(n_dev)],
            [(i, (i - 1) % n_dev) for i in range(n_dev)])


def _pp(mesh: Mesh, axis: str, dst: str, src, perm) -> Collective:
    """``src(buffers)`` moved by ``perm`` into the buffer ``dst``."""
    return Collective(lambda b: keep(b, dst, ppermute(mesh, src(b), perm,
                                                      axis)))


def _exchange(mesh: Mesh, axis: str, sep: int, name: str) -> list:
    """The halo exchange of the [Fb, ...] owned values in buffer ``name``:
    the separator slabs of the two ring neighbours, one permutation
    each, into ``name``_l and ``name``_r (``_window``)."""
    right, left = _rings(mesh.axis(axis).size)
    return [_pp(mesh, axis, name + "_l", lambda b: b[name][-sep:], right),
            _pp(mesh, axis, name + "_r", lambda b: b[name][:sep], left)]


def _window(b: dict, name: str) -> torch.Tensor:
    """[W, ...] window values of ``name`` after its ``_exchange``."""
    return torch.cat([b[name + "_l"], b[name], b[name + "_r"]])


def _arange(n: int, dev) -> torch.Tensor:
    return cached_constant(("pose_sharded.arange", n),
                           lambda: torch.arange(n), dev)


def _eye6(dev) -> torch.Tensor:
    return cached_constant(("pose_sharded.eye6",),
                           lambda: torch.eye(6, dtype=torch.float32), dev)


def bundle_adjust_pose_sharded(
    mesh: Mesh,
    cam: Camera,
    problem: BaProblem,
    iters: int = 10,
    cg_iters: int = 128,
    sep: int = 3,
    damping: float = 1e-3,
    depth_weight: float = 50.0,
    odo_weight_t: float = 20.0,
    odo_weight_r: float = 50.0,
    lcp_weight_t: float = 20.0,
    lcp_weight_r: float = 50.0,
    axis: str = "blk",
) -> tuple[BaResult, dict]:
    """Keyframe-block-sharded BA. Returns (BaResult, report), the same on
    every rank.

    No observation is ever dropped (report["dropped_obs"] == 0 always):
    landmarks whose observation span fits a block window are handled
    block-locally; the rest (report["global_lm"] of them) join a
    replicated global factor group whose Schur elimination runs
    identically on every rank over the all-gathered pose vector. The
    factor set is backend.ba.bundle_adjust's on any problem. Keep the
    global group small relative to L: its linearization is replicated
    work ([Fpad × Lg] residual grid per rank).

    The reference jits the solve whole. Here the host partitions the
    problem once per solve (numpy, as the reference does outside its
    program) and sets up this rank's block, which is copied into a
    ``MeshProgram`` (``parallel/programs.py``) with the variants
    ``cost0`` and ``iteration``, keyed by the block's shapes, the
    camera, ``sep``, ``cg_iters``, the odometry weights and the mesh
    axis, never by ``iters``. At one rank each run is one graph replay,
    the ``cg_iters`` PCG iterations unrolled inside it; across ranks
    each segment between two collectives is a graph, the PCG iteration's
    four replayed ``cg_iters`` times."""
    ax = mesh.axis(axis)
    n_dev, b_idx = ax.size, ax.rank
    problem = BaProblem(*(None if x is None else globalize_replicated(mesh, x)
                          for x in problem))
    dev = problem.kf_t.device
    f_true = problem.mask.shape[0]
    # sep ≤ fb: the halo exchange slices x_own[-sep:] (at most fb rows)
    # and the halo reduce only talks to the immediate ring neighbours
    fb_pre = (f_true + n_dev - 1) // n_dev
    sep = max(1, min(sep, fb_pre))
    data, report = _partition(BaProblem(*(_np(x) for x in problem)), n_dev,
                              sep)
    fb = report["fb"]
    fpad = fb * n_dev
    has_global = data.pop("n_global") > 0
    # loop-closure pose factors (arbitrary keyframe pairs) also ride the
    # all-gathered pose vector: they need the gather even with zero
    # global landmarks
    has_lcp = problem.lcp_i is not None
    need_glob = has_global or has_lcp
    f32 = torch.float32

    def mine(name):  # this block's slice of a per-block array
        return torch.as_tensor(data[name][b_idx]).to(dev)

    def rep(x):
        return torch.as_tensor(x).to(dev)

    # the per-solve set-up: this rank's block, its masks and weights
    b_mask = mine("b_mask")
    gauge = np.ones(fpad, np.float32)
    gauge[0] = 0.0  # pose 0 is frozen
    own = slice(b_idx * fb, (b_idx + 1) * fb)
    own_valid = (np.arange(fpad) < f_true).astype(np.float32)[own]
    keep_own = rep(gauge[own] * own_valid)  # [Fb]: owned pose takes part
    win_valid = mine("win_valid")
    halo = {"keep_own": keep_own}
    for c in _exchange(mesh, axis, sep, "keep_own"):
        c.fn(halo)
    keep_win = _window(halo, "keep_own") * win_valid
    glob = lcp = None
    if has_global:
        g_mask = rep(data["g_mask"])
        glob = (rep(data["g_uv"]), rep(data["g_xyz"]), g_mask,
                (g_mask & rep(data["g_mask_xyz"])).to(f32) * depth_weight,
                torch.where(rep(data["g_lc"])[None, :], 1e6, 3.0).to(f32))
    if has_lcp:
        n_lcp = problem.lcp_i.shape[0]
        # per-factor square-root information (the scalar weights'
        # diagonal when the problem carries none)
        info = problem.lcp_info
        if info is None:
            info = cached_constant(
                ("lcp_info", lcp_weight_t, lcp_weight_r, f32),
                lambda: torch.diag(torch.tensor(
                    [lcp_weight_t] * 3 + [lcp_weight_r] * 3, dtype=f32)),
                dev)[None].expand(n_lcp, 6, 6)
        lcp = (problem.lcp_i.to(torch.int64), problem.lcp_j.to(torch.int64),
               problem.lcp_t, problem.lcp_q,
               problem.lcp_w if problem.lcp_w is not None
               else torch.ones(n_lcp, dtype=f32, device=dev), info)
    block = _Block(
        mine("b_uv"), mine("b_xyz"), b_mask,
        (b_mask & mine("b_mask_xyz")).to(f32) * depth_weight,
        torch.where(mine("b_lc")[None, :], 1e6, 3.0).to(f32),
        (mine("b_odo_t"), mine("b_odo_q"), mine("b_odo_w")), win_valid,
        keep_own, keep_win,
        all_gather(mesh, keep_own, axis) if need_glob else None, glob, lcp)
    init = (mine("kf_t"), mine("kf_q"), mine("points"),
            rep(data["g_points"]))
    fused = fuses(mesh, axis)

    def make():
        bufs = dict(problem=empty_like_tree(block),
                    **{k: torch.empty_like(v) for k, v in zip(
                        ("t_own", "q_own", "pts", "pts_g"), init)},
                    lam=torch.empty((), dtype=f32, device=dev),
                    c0=torch.empty((), dtype=f32, device=dev))
        return MeshProgram("bundle_adjust_pose_sharded", bufs, dev, fused)

    prog = program(("bundle_adjust_pose_sharded", cam, sep, cg_iters,
                    odo_weight_t, odo_weight_r, fused, ax.size, ax.rank,
                    ax.group, shape_key(block, init)), make)
    b = prog.buffers
    load((b["problem"], b["t_own"], b["q_own"], b["pts"], b["pts_g"]),
         (block, *init))
    b["lam"].fill_(damping)
    schedules = _schedules(mesh, cam, axis, sep, fb, cg_iters, odo_weight_t,
                           odo_weight_r, has_global, has_lcp)
    cost = torch.empty(iters + 1, dtype=f32, device=dev)
    for i, variant in enumerate(["cost0"] + ["iteration"] * iters):
        prog.run_schedule(mesh, variant, schedules[variant])
        cost[i].copy_(b["c0"])

    # un-partition back to the problem's global indexing
    kf_t = all_gather(mesh, b["t_own"], axis)[:f_true]
    kf_q = all_gather(mesh, b["q_own"], axis)[:f_true]
    if ax.group is None:  # one process: the gather is the buffer itself
        kf_t, kf_q = kf_t.clone(), kf_q.clone()
    points = problem.points.clone()
    lvalid = rep(data["b_lvalid"].reshape(-1))
    lidx = rep(data["b_lidx"].reshape(-1))[lvalid]
    points[lidx] = all_gather(mesh, b["pts"], axis)[lvalid]
    g_lvalid = rep(data["g_lvalid"])
    points[rep(data["g_lidx"])[g_lvalid]] = b["pts_g"][g_lvalid]
    return BaResult(kf_t=kf_t, kf_q=kf_q, points=points, cost=cost), report

