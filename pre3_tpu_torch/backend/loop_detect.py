"""Keyframe-to-keyframe loop-closure detection → relative-pose factors.

Port of ``pre3_tpu/backend/loop_detect.py``. Candidate keyframe pairs
that are far apart along the path but near in the (drifted) estimate are
descriptor-matched (K2, ``match_descriptors_auto``) and verified by the
batched rigid RANSAC (K1-scored ``ransac_rigid``); a pair that passes
yields one relative SE(3) factor (``BaProblem.lcp_*``) with the
square-root information of its Kabsch fit's IFT covariance.

A host loop over a handful of candidate pairs, reading each pair's
verdict back once, as the reference does. The reference's jitted
``match_and_fit`` is a step program (``utils/graphs.py``) keyed by one
pair's shapes and the mining's config: its input row holds the pair's
two keyframes (descriptors, points, validity; staged ``STAGE_ROWS``
pairs at a time) and, when injected, its draws; its output row the fit
(R, t, q, ok, inliers, RMSE) and the IFT covariance, computed for every
pair as the reference does. On the card each pair is one replay of a
captured CUDA graph with K2 and K1 inside, and its output row comes back
to the host in one copy, the verdict read; on the CPU the same body runs
eagerly. The RANSAC draws of the n-th pair tried are ``gumbel[n]`` or
come from ``generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.quaternion import r2q
from pre3_tpu_torch.ops.matching import match_descriptors_auto
from pre3_tpu_torch.ops.vo_covariance import vo_covariance
from pre3_tpu_torch.utils.graphs import (
    STAGE_ROWS, Packing, StepProgram, program, shape_key,
)
from pre3_tpu_torch.vo.ransac import ransac_rigid

# conservative noise floor added to every factor covariance so the
# sqrt-information never claims better than ~5 mm / 0.25°
_COV_FLOOR = np.diag([2.5e-5] * 3 + [2e-5] * 3)

# variance inflation of the IFT model, calibrated against ground truth in
# the reference (25 = (5σ)²)
_COV_INFLATION = 25.0


def sqrt_information(cov: np.ndarray) -> np.ndarray:
    """[6, 6] upper-triangular whitening matrix L with ‖L r‖² =
    rᵀ Σ⁻¹ r for Σ = inflation·cov + floor (numpy, float64 inside)."""
    sig = _COV_INFLATION * np.asarray(cov, np.float64) + _COV_FLOOR
    info = np.linalg.inv(sig)
    info = 0.5 * (info + info.T)
    return np.linalg.cholesky(info).T.astype(np.float32)  # upper: r↦L r


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def pairs_to_try(kf_t, kf_valid, min_gap: int = 8, max_dist: float = 1.2,
                 min_path_ratio: float = 2.0) -> list[tuple[int, int]]:
    """The (a, b) keyframe pairs mine_keyframe_loop_closures tries, in its
    order: loop-like pairs, far apart along the keyframe path and near in
    the estimate (path/dist ≥ min_path_ratio), most loop-like first, one
    per ±2 keyframe neighbourhood. The mining stops once ``max_pairs``
    factors are accepted, so it tries all of them when it returns fewer
    than ``max_pairs`` factors, else those up to its last factor's pair."""
    kf_t, kf_valid = _numpy(kf_t), _numpy(kf_valid)
    m = len(kf_t)
    seg = np.linalg.norm(np.diff(kf_t, axis=0), axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    cands = []
    for a in range(m):
        if not kf_valid[a]:
            continue
        for b in range(a + min_gap, m):
            if not kf_valid[b]:
                continue
            d = float(np.linalg.norm(kf_t[a] - kf_t[b]))
            if d >= max_dist:
                continue
            r_loop = float(cum[b] - cum[a]) / max(d, 0.05)
            if r_loop >= min_path_ratio:
                cands.append((-r_loop, a, b))
    cands.sort()
    seen, pairs = set(), []
    for _score, a, b in cands:
        if (a, b) in seen:
            continue
        # neighbour suppression: one factor per trajectory neighbourhood
        for da in (-2, -1, 0, 1, 2):
            for db in (-2, -1, 0, 1, 2):
                seen.add((a + da, b + db))
        pairs.append((a, b))
    return pairs


def pair_fit(fa, fb, gumbel=None, generator=None, ratio: float = 1.3,
             batch: int = 1024, min_inliers: int = 12):
    """The reference's ``match_and_fit`` on one candidate pair, each side
    a (desc, xyz, valid) triple: K2 matching, the K1-scored rigid RANSAC
    and the fit's IFT covariance → (r, t, q, ok, n_inliers, rmse, cov)."""
    (a_desc, a_xyz, a_valid), (b_desc, b_xyz, b_valid) = fa, fb
    mt = match_descriptors_auto(a_desc, b_desc, valid1=a_valid,
                                valid2=b_valid, ratio=ratio)
    p_a, p_b = a_xyz, b_xyz[mt.index]
    ok = (mt.accepted & a_valid
          & (torch.linalg.vector_norm(p_a, dim=-1) > 0.2)
          & (torch.linalg.vector_norm(p_b, dim=-1) > 0.2))
    fit = ransac_rigid(p_a, p_b, ok, batch=batch, min_inliers=min_inliers,
                       gumbel=gumbel, generator=generator)
    cov = vo_covariance(fit.r, fit.t, p_a, p_b, fit.inliers.to(p_a.dtype))
    return (fit.r, fit.t, r2q(fit.r), fit.ok, fit.n_inliers, fit.rmse, cov)


def mine_keyframe_loop_closures(
    kf_feats: Features,  # stacked over the M keyframes
    kf_t,  # [M, 3] estimated keyframe positions (world)
    kf_q,  # [M, 4]
    kf_valid,  # [M]
    min_gap: int = 8,  # keyframe-index gap of a candidate pair
    max_dist: float = 1.2,  # m — estimated-proximity gate
    min_path_ratio: float = 2.0,  # loop-likeness gate
    min_inliers: int = 12,
    max_pairs: int = 16,  # strongest-first budget
    ratio: float = 1.3,
    batch: int = 1024,
    gumbel: torch.Tensor | None = None,  # [pairs tried, batch, Kf]
    generator: torch.Generator | None = None,
):
    """Returns (lcp_i, lcp_j, lcp_t, lcp_q, lcp_w, lcp_info) numpy arrays
    or None. lcp_t = R_iᵀ(t_j − t_i), lcp_q = q_i⁻¹ ⊗ q_j, estimated from
    the matched camera-frame point sets (p_i ≈ R·p_j + t), with no
    dependence on the drifted world poses. The pairs tried are those of
    ``pairs_to_try`` up to the budget, each one run of the pair program
    (see the module docstring)."""
    pairs = pairs_to_try(kf_t, kf_valid, min_gap, max_dist, min_path_ratio)
    if not pairs:
        return None
    dev = kf_feats.xyz.device
    side = lambda i: (kf_feats.desc[i], kf_feats.xyz[i],  # noqa: E731
                      kf_feats.valid[i])
    gens = [] if gumbel is not None else [generator]
    one = (side(0), side(0), None if gumbel is None else gumbel[0])
    pin = Packing(one)
    dt = kf_feats.xyz.dtype
    pout = Packing(tuple(torch.empty(shape, dtype=d) for shape, d in (
        ((3, 3), dt), ((3,), dt), ((4,), dt), ((), torch.bool),
        ((), torch.int32), ((), dt), ((6, 6), dt))))

    def make():
        bufs = dict(inp=pin.rows(device=dev), out=pout.rows(device=dev))
        return StepProgram("mine_keyframe_loop_closures", bufs, dev,
                           len(gens))

    prog = program(("mine_keyframe_loop_closures", ratio, batch, min_inliers,
                    len(gens), shape_key(one)), make)

    def body(bufs, gens_):
        fa, fb, g = pin.unpack(bufs["inp"])
        pout.pack(pair_fit(fa, fb, g, gens_[0] if gens_ else None, ratio,
                           batch, min_inliers), bufs["out"])

    out_i, out_j, out_t, out_q, out_l = [], [], [], [], []
    in_rows = pin.rows(min(len(pairs), STAGE_ROWS), device=dev)
    for n_tried, (a, b) in enumerate(pairs):
        if len(out_i) >= max_pairs:
            break
        lo = n_tried - n_tried % STAGE_ROWS
        if lo == n_tried:  # stage the next block of pairs
            hi = min(len(pairs), lo + STAGE_ROWS)
            ab = torch.as_tensor(pairs[lo:hi]).to(dev)
            pin.pack((side(ab[:, 0]), side(ab[:, 1]),
                      None if gumbel is None else gumbel[lo:hi]),
                     in_rows[:hi - lo])
        prog.buffers["inp"].copy_(in_rows[n_tried - lo])
        prog.run(None, body, gens)
        _r, t, q, ok, _n, _rmse, cov = pout.unpack(
            prog.buffers["out"].to("cpu", copy=True))  # the verdict read
        if not bool(ok):
            continue
        out_i.append(a)
        out_j.append(b)
        out_t.append(t.numpy().astype(np.float32))
        out_q.append(q.numpy().astype(np.float32))
        out_l.append(sqrt_information(cov.numpy()))
    if not out_i:
        return None
    return (np.asarray(out_i, np.int32), np.asarray(out_j, np.int32),
            np.stack(out_t), np.stack(out_q),
            np.ones(len(out_i), np.float32), np.stack(out_l))


def merge_lcp(problem, lcp):
    """Concatenate mined keyframe-rematch factors (the 6-tuple of
    mine_keyframe_loop_closures, or None) onto a BaProblem's existing
    lcp factors, dropping mined pairs that duplicate an existing (i, j).
    The merged problem always carries lcp_info, on the problem's
    device."""
    if lcp is None:
        return problem
    dev = problem.kf_t.device
    li, lj, lt, lq, lw, linfo = (np.asarray(x) for x in lcp)
    if problem.lcp_i is not None:
        have = set(zip(_numpy(problem.lcp_i).tolist(),
                       _numpy(problem.lcp_j).tolist()))
        keep = np.asarray([(int(a), int(b)) not in have
                           for a, b in zip(li, lj)])
        if not keep.any():
            return problem
        li, lj, lt, lq, lw, linfo = (x[keep] for x in
                                     (li, lj, lt, lq, lw, linfo))
    new = [torch.as_tensor(x).to(dev) for x in (li, lj, lt, lq, lw, linfo)]
    if problem.lcp_i is not None:
        g0 = problem.lcp_i.shape[0]
        old_w = problem.lcp_w if problem.lcp_w is not None else torch.ones(
            g0, dtype=torch.float32, device=dev)
        old_info = problem.lcp_info if problem.lcp_info is not None else (
            torch.diag(torch.tensor([20.0] * 3 + [50.0] * 3)).to(dev)
            .expand(g0, 6, 6))
        new = [torch.cat([o, n]) for o, n in zip(
            (problem.lcp_i, problem.lcp_j, problem.lcp_t, problem.lcp_q,
             old_w, old_info), new)]
    return problem._replace(lcp_i=new[0], lcp_j=new[1], lcp_t=new[2],
                            lcp_q=new[3], lcp_w=new[4], lcp_info=new[5])
