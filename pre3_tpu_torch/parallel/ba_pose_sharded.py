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
un-partition back to global indices are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from pre3_tpu_torch.backend.ba import (
    BaProblem, BaResult, _build_normal_eqs, _cost_sums, _odo_cost_sums,
    _odo_terms, _pair_residual_jacobians,
)
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.quaternion import qnormalize, qprod, v2q
from pre3_tpu_torch.parallel.distributed import globalize_replicated
from pre3_tpu_torch.parallel.mesh import Mesh, all_gather, ppermute, psum


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
    work ([Fpad × Lg] residual grid per rank)."""
    ax = mesh.axis(axis)
    n_dev, b_idx = ax.size, ax.rank
    problem = BaProblem(*(None if x is None else globalize_replicated(mesh, x)
                          for x in problem))
    dev = problem.kf_t.device
    f_true = problem.mask.shape[0]
    # sep ≤ fb: halo_exchange slices x_own[-sep:] (at most fb rows) and
    # halo_reduce only talks to the immediate ring neighbours
    fb_pre = (f_true + n_dev - 1) // n_dev
    sep = max(1, min(sep, fb_pre))
    data, report = _partition(BaProblem(*(_np(x) for x in problem)), n_dev,
                              sep)
    fb, w = report["fb"], report["window"]
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

    b_uv, b_xyz, b_mask = mine("b_uv"), mine("b_xyz"), mine("b_mask")
    w_xyz = (b_mask & mine("b_mask_xyz")).to(f32) * depth_weight
    hub = torch.where(mine("b_lc")[None, :], 1e6, 3.0).to(f32)
    b_odo = (mine("b_odo_t"), mine("b_odo_q"), odo_weight_t, odo_weight_r,
             mine("b_odo_w"))
    win_valid = mine("win_valid")
    gauge = np.ones(fpad, np.float32)
    gauge[0] = 0.0  # pose 0 is frozen
    own = slice(b_idx * fb, (b_idx + 1) * fb)
    gauge_own = rep(gauge[own])
    own_valid = rep((np.arange(fpad) < f_true).astype(np.float32)[own])
    keep_own = gauge_own * own_valid  # [Fb]: owned pose takes part

    g_uv, g_xyz = rep(data["g_uv"]), rep(data["g_xyz"])
    g_mask = rep(data["g_mask"])
    g_wxyz = (g_mask & rep(data["g_mask_xyz"])).to(f32) * depth_weight
    g_hub = torch.where(rep(data["g_lc"])[None, :], 1e6, 3.0).to(f32)
    if has_lcp:
        n_lcp = problem.lcp_i.shape[0]
        i_p = problem.lcp_i.to(torch.int64)
        j_p = problem.lcp_j.to(torch.int64)
        lcp_w = (problem.lcp_w if problem.lcp_w is not None
                 else torch.ones(n_lcp, dtype=f32, device=dev))
        # per-factor square-root information (the scalar weights'
        # diagonal when the problem carries none)
        info = problem.lcp_info
        if info is None:
            diag = torch.tensor([lcp_weight_t] * 3 + [lcp_weight_r] * 3,
                                dtype=f32)
            info = torch.diag(diag).to(dev)[None].expand(n_lcp, 6, 6)
        lcp = (i_p, j_p, problem.lcp_t, problem.lcp_q, 1.0, 1.0, lcp_w, info)

    ring_right = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    ring_left = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def halo_exchange(x_own):
        """[Fb, ...] owned values → [W, ...] window values: the separator
        slabs of the two ring neighbours, one permutation each."""
        right_of_left = ppermute(mesh, x_own[-sep:], ring_right, axis)
        left_of_right = ppermute(mesh, x_own[:sep], ring_left, axis)
        return torch.cat([right_of_left, x_own, left_of_right])

    def halo_reduce(y_win):
        """[W, ...] window contributions → [Fb, ...] owned sums: my own
        slice plus the neighbours' contributions to my boundary poses."""
        to_left = ppermute(mesh, y_win[:sep], ring_left, axis)
        to_right = ppermute(mesh, y_win[-sep:], ring_right, axis)
        out = y_win[sep:sep + fb].clone()
        out[-sep:] += to_left
        out[:sep] += to_right
        return out

    def gather(x):  # [Fb, ...] → [Fpad, ...]
        return all_gather(mesh, x, axis)

    def own_rows(x_glob):  # [Fpad, ...] → this block's [Fb, ...]
        return x_glob[own]

    ar_w = torch.arange(w, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    keep_win = halo_exchange(keep_own) * win_valid  # [W]
    keep_glob = gather(keep_own) if need_glob else None  # [Fpad]

    def global_linearize(t_glob, q_glob, pts_g, lam):
        """Replicated linearization of the global-landmark factor group
        over the all-gathered poses [Fpad, ...]: identical on every rank;
        its results enter the distributed matvec through own-row slices."""
        hcc_g, hpp_g, wcp_g, bc_g, bp_g = _build_normal_eqs(
            cam, t_glob, q_glob, pts_g, g_uv, g_mask, g_xyz, g_wxyz, lam,
            huber_delta=g_hub)
        # λ is already on every pose's diagonal from the window
        # linearization: drop the duplicate
        hcc_g = hcc_g - lam * eye6[None]
        hpp_g_inv, _ = torch.linalg.inv_ex(hpp_g)
        rhs_g = (bc_g - torch.einsum("flab,lbc,lc->fa", wcp_g, hpp_g_inv,
                                     bp_g)) * keep_glob[:, None]
        diag_g = hcc_g - torch.einsum("flab,lbc,fldc->fad", wcp_g,
                                      hpp_g_inv, wcp_g)
        return hcc_g, hpp_g_inv, wcp_g, bp_g, rhs_g, diag_g

    def gn_body(t_own, q_own, pts, pts_g, lam):
        """One Gauss-Newton step: (dc_own [Fb, 6], dp [Lb, 3], dp_g)."""
        t_win, q_win = halo_exchange(t_own), halo_exchange(q_own)
        m_eff = b_mask & win_valid[:, None]
        hcc, hpp, wcp, bc, bp = _build_normal_eqs(
            cam, t_win, q_win, pts, b_uv, m_eff, b_xyz,
            w_xyz * win_valid[:, None].to(f32), lam, huber_delta=hub)
        hpp_inv, _ = torch.linalg.inv_ex(hpp)
        # window operator S_b = diag(hcc) − W Hpp⁻¹ Wᵀ  [W, 6, W, 6]
        s_win = -torch.einsum("flab,lbc,gldc->fagd", wcp, hpp_inv, wcp)
        s_win[ar_w, :, ar_w, :] += hcc
        rhs_win = bc - torch.einsum("flab,lbc,lc->fa", wcp, hpp_inv, bp)
        # the block's odometry factors on window poses [sep, sep + fb]
        o = slice(sep, sep + fb + 1)
        s_add, rhs_add, _, _ = _odo_terms(t_win[o], q_win[o], *b_odo)
        s_win[o, :, o, :] += s_add
        rhs_win[o] += rhs_add
        # gauge + validity: zero the rows and columns of frozen and
        # padded poses; win_valid also kills the ring's wraparound halos
        # at the chain's ends
        s_win = (s_win * keep_win[:, None, None, None]
                 * keep_win[None, None, :, None])
        rhs_win = rhs_win * keep_win[:, None]

        # the distributed rhs and Jacobi blocks
        rhs_own = halo_reduce(rhs_win)  # [Fb, 6]
        diag_own = halo_reduce(s_win[ar_w, :, ar_w, :])  # [Fb, 6, 6]
        if need_glob:
            t_glob, q_glob = gather(t_own), gather(q_own)
        if has_global:
            hcc_g, hpp_g_inv, wcp_g, bp_g, rhs_g, diag_g = global_linearize(
                t_glob, q_glob, pts_g, lam)
            rhs_own = rhs_own + own_rows(rhs_g)
            diag_own = diag_own + own_rows(diag_g) * keep_own[:, None, None]
        if has_lcp:
            # keyframe-pair factors, linearized replicated on the gathered
            # poses; their action enters the matvec factored (Jᵀ(Jx))
            r_p, ji_p, jj_p = _pair_residual_jacobians(
                t_glob, q_glob, *lcp)
            rhs_p = torch.zeros((fpad, 6), dtype=f32, device=dev)
            rhs_p.index_add_(0, i_p, -torch.einsum("pab,pa->pb", ji_p, r_p))
            rhs_p.index_add_(0, j_p, -torch.einsum("pab,pa->pb", jj_p, r_p))
            diag_p = torch.zeros((fpad, 6, 6), dtype=f32, device=dev)
            diag_p.index_add_(0, i_p, torch.einsum("pab,pac->pbc", ji_p,
                                                   ji_p))
            diag_p.index_add_(0, j_p, torch.einsum("pab,pac->pbc", jj_p,
                                                   jj_p))
            rhs_own = rhs_own + own_rows(rhs_p * keep_glob[:, None])
            diag_own = diag_own + own_rows(diag_p) * keep_own[:, None, None]

        prec, _ = torch.linalg.inv_ex(
            diag_own + 1e-8 * eye6[None]
            + (1.0 - keep_own)[:, None, None] * eye6[None])  # frozen: I

        def matvec(x_own):  # [Fb, 6] → [Fb, 6]
            xk = x_own * keep_own[:, None]
            y_win = torch.einsum("fagb,gb->fa", s_win, halo_exchange(xk))
            y = halo_reduce(y_win)
            if need_glob:
                x_glob = gather(xk) * keep_glob[:, None]  # [Fpad, 6]
            if has_global:
                u = torch.einsum("flab,fa->lb", wcp_g, x_glob)
                v = torch.einsum("lab,lb->la", hpp_g_inv, u)
                y_g = (torch.einsum("fab,fb->fa", hcc_g, x_glob)
                       - torch.einsum("flab,lb->fa", wcp_g, v))
                y = y + own_rows(y_g * keep_glob[:, None])
            if has_lcp:
                jx = (torch.einsum("pab,pb->pa", ji_p, x_glob[i_p])
                      + torch.einsum("pab,pb->pa", jj_p, x_glob[j_p]))
                y_p = torch.zeros_like(x_glob)
                y_p.index_add_(0, i_p, torch.einsum("pab,pa->pb", ji_p, jx))
                y_p.index_add_(0, j_p, torch.einsum("pab,pa->pb", jj_p, jx))
                y = y + own_rows(y_p * keep_glob[:, None])
            return y * keep_own[:, None]

        def pdot(a, b):
            return psum(mesh, torch.sum(a * b), axis)

        # block-Jacobi PCG, fixed trip count: no host read, no early exit
        x = torch.zeros((fb, 6), dtype=f32, device=dev)
        r = rhs_own * keep_own[:, None]
        z = torch.einsum("fab,fb->fa", prec, r)
        p = z
        rz = pdot(r, z)
        for _ in range(cg_iters):
            ap = matvec(p)
            alpha = rz / torch.clamp(pdot(p, ap), min=1e-30)
            x = x + alpha * p
            r = r - alpha * ap
            z = torch.einsum("fab,fb->fa", prec, r)
            rz_new = pdot(r, z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            p = z + beta * p
            rz = rz_new

        # landmark back-substitution (block-local; global replicated)
        dp = torch.einsum("lab,lb->la", hpp_inv,
                          bp - torch.einsum("flab,fa->lb", wcp,
                                            halo_exchange(x)))
        if has_global:
            dp_g = torch.einsum(
                "lab,lb->la", hpp_g_inv,
                bp_g - torch.einsum("flab,fa->lb", wcp_g, gather(x)))
        else:
            dp_g = torch.zeros_like(pts_g)
        return x, dp, dp_g

    def block_cost(t_own, q_own, pts, pts_g):
        t_win, q_win = halo_exchange(t_own), halo_exchange(q_own)
        tot, n = _cost_sums(
            cam, t_win, q_win, pts, b_uv, b_mask & win_valid[:, None],
            b_xyz, w_xyz * win_valid[:, None].to(f32), huber_delta=hub)
        o = slice(sep, sep + fb + 1)
        ot, on = _odo_cost_sums(t_win[o], q_win[o], b_odo)
        tot, n = tot + ot, (n + on).to(f32)
        if need_glob:
            # every rank computes the identical global-factor cost;
            # scaling it by 1/n before the sum counts it once
            t_glob, q_glob = gather(t_own), gather(q_own)
        if has_global:
            gt, gn = _cost_sums(cam, t_glob, q_glob, pts_g, g_uv, g_mask,
                                g_xyz, g_wxyz, huber_delta=g_hub)
            tot, n = tot + gt / n_dev, n + gn / n_dev
        if has_lcp:
            r_p, _, _ = _pair_residual_jacobians(t_glob, q_glob, *lcp)
            tot = tot + torch.sum(r_p * r_p) / n_dev
            n = n + torch.sum(lcp_w > 0) / n_dev
        sums = psum(mesh, torch.stack([tot, n]), axis)
        return sums[0] / torch.clamp(sums[1], min=1)

    t_own, q_own = mine("kf_t"), mine("kf_q")
    pts, pts_g = mine("points"), rep(data["g_points"])
    lam = torch.full((), damping, dtype=f32, device=dev)
    # pre-optimization cost first, as in every BA implementation
    costs = [block_cost(t_own, q_own, pts, pts_g)]
    for _ in range(iters):
        c0 = costs[-1]
        dc, dp, dp_g = gn_body(t_own, q_own, pts, pts_g, lam)
        t2 = t_own + dc[:, :3]
        q2 = qnormalize(qprod(q_own, v2q(dc[:, 3:])))
        p2, p2_g = pts + dp, pts_g + dp_g
        c1 = block_cost(t2, q2, p2, p2_g)
        better = c1 < c0
        t_own = torch.where(better, t2, t_own)
        q_own = torch.where(better, q2, q_own)
        pts = torch.where(better, p2, pts)
        pts_g = torch.where(better, p2_g, pts_g)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-8),
                          torch.clamp(lam * 10.0, max=1e6))
        costs.append(torch.where(better, c1, c0))

    # un-partition back to the problem's global indexing
    kf_t = gather(t_own)[:f_true]
    kf_q = gather(q_own)[:f_true]
    points = problem.points.clone()
    lvalid = rep(data["b_lvalid"].reshape(-1))
    lidx = rep(data["b_lidx"].reshape(-1))[lvalid]
    points[lidx] = gather(pts)[lvalid]
    g_lvalid = rep(data["g_lvalid"])
    points[rep(data["g_lidx"])[g_lvalid]] = pts_g[g_lvalid]
    return BaResult(kf_t=kf_t, kf_q=kf_q, points=points,
                    cost=torch.stack(costs)), report
