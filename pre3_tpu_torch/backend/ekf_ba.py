"""Bridge: EKF-SLAM inlier records → keyframe bundle-adjustment problem.

Port of ``pre3_tpu/backend/ekf_ba.py``. The filter's per-frame inlier
observations (``StepRecord``: 1-point RANSAC + χ² rescue vetted) become
BA factors; a landmark's identity is (slot, init_frame), since slots are
reused after deletion.

Host-side assembly, as in the reference: the records and the trajectory
are brought to the host once, the problem is assembled with numpy (and
the port's ``qrotate``, ``kabsch`` and ``vo_covariance`` on CPU
tensors), and the BaProblem is returned on the trajectory's device.
"""

from __future__ import annotations

import numpy as np
import torch

from pre3_tpu_torch.backend.ba import BaProblem
from pre3_tpu_torch.backend.loop_detect import _numpy, sqrt_information
from pre3_tpu_torch.geometry.quaternion import (
    qconj, qnormalize, qprod, qrotate, r2q,
)
from pre3_tpu_torch.vo.covariance import vo_covariance
from pre3_tpu_torch.vo.rigid import kabsch


def _rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """qrotate on numpy f32 arrays (batched), computed as CPU tensors."""
    return qrotate(torch.as_tensor(q), torch.as_tensor(v)).numpy()


def ba_problem_from_slam(
    traj,  # SlamTrajectory (t, q, records with leading axis F-1)
    kf_indices,  # [M] frame indices (keyframes)
    kf_valid,  # [M]
    min_obs: int = 2,
    max_landmarks: int | None = None,
    kf_feats=None,  # Features stacked over the M keyframes (optional)
    merge_eps: float = 0.15,  # m — world-point identification radius
    lc_gap: int = 15,  # frames — re-measured after ≥ lc_gap unmeasured
    # frames (out of view) makes a loop-closure landmark; 0 = off
) -> BaProblem | None:
    """Build the masked BA tensors from recorded inlier observations.

    Records exist for frames 1..F-1; a keyframe at frame 0 contributes no
    observations but anchors the gauge. Returns None when no landmark is
    observed in ≥ min_obs keyframes. With ``kf_feats``, keyframe tracks
    (``backend/tracks.py``, K2 once per keyframe) are merged into the
    filter-record landmarks by world-point proximity (< merge_eps)."""
    rec = traj.records
    z, z_xyz = _numpy(rec.z), _numpy(rec.z_xyz)  # [F-1, K, 2 | 3]
    measured, init_frame = _numpy(rec.measured), _numpy(rec.init_frame)
    rec_visible = None if getattr(rec, "visible", None) is None else (
        _numpy(rec.visible))
    t_all, q_all = _numpy(traj.t), _numpy(traj.q)
    dev = traj.t.device if isinstance(traj.t, torch.Tensor) else (
        torch.device("cpu"))

    kf_indices = _numpy(kf_indices)
    kf_valid = _numpy(kf_valid).astype(bool)
    m = len(kf_indices)
    k = z.shape[1]

    # landmark ids observed at keyframes, in first-seen order
    ids: dict[tuple[int, int], int] = {}
    obs_list: list[tuple[int, int, np.ndarray, np.ndarray]] = []
    for mi, f in enumerate(kf_indices):
        if not kf_valid[mi] or f == 0:
            continue
        r = f - 1  # record row of frame f
        for slot in np.nonzero(measured[r])[0]:
            lid = (int(slot), int(init_frame[r, slot]))
            if lid not in ids:
                ids[lid] = len(ids)
            obs_list.append((mi, ids[lid], z[r, slot], z_xyz[r, slot]))
    if not ids:
        return None
    counts = np.zeros(len(ids), int)
    for _, li, _, _ in obs_list:
        counts[li] += 1
    keep = counts >= min_obs
    if max_landmarks is not None and keep.sum() > max_landmarks:
        order = np.argsort(-counts)
        sel = np.zeros_like(keep)
        sel[order[:max_landmarks]] = True
        keep &= sel
    remap = -np.ones(len(ids), int)
    remap[keep] = np.arange(keep.sum())
    l = int(keep.sum())
    if l == 0:
        return None

    obs_uv = np.zeros((m, l, 2), np.float32)
    obs_xyz = np.zeros((m, l, 3), np.float32)
    mask = np.zeros((m, l), bool)
    # landmark world init from the first depth observation
    points = np.zeros((l, 3), np.float32)
    have_init = np.zeros(l, bool)
    for mi, li, uv, xyz in obs_list:
        li2 = remap[li]
        if li2 < 0:
            continue
        obs_uv[mi, li2] = uv
        obs_xyz[mi, li2] = xyz
        mask[mi, li2] = True
        if not have_init[li2] and np.linalg.norm(xyz) > 0.2:
            f = kf_indices[mi]
            points[li2] = _rotate(q_all[f], xyz) + t_all[f]
            have_init[li2] = True
    mask &= have_init[None]

    # optional cross-keyframe re-matching merge
    if kf_feats is not None and l > 0:
        from pre3_tpu_torch.backend.tracks import build_tracks

        fdev = kf_feats.desc.device
        t_uv, t_xyz, t_mask, table = build_tracks(
            kf_feats, torch.as_tensor(t_all[kf_indices]).to(fdev),
            torch.as_tensor(q_all[kf_indices]).to(fdev),
            torch.as_tensor(kf_valid).to(fdev), max_tracks=min(4 * l, 512))
        t_uv, t_xyz, t_mask = _numpy(t_uv), _numpy(t_xyz), _numpy(t_mask)
        t_pw, t_act = _numpy(table.point_w), _numpy(table.active)
        for l2 in np.nonzero(t_act & (t_mask.sum(0) >= 2))[0]:
            d = np.linalg.norm(points - t_pw[l2], axis=-1)
            j = int(np.argmin(d))
            if d[j] > merge_eps or not have_init[j]:
                continue
            # track observations at keyframes the filter missed
            new = t_mask[:, l2] & ~mask[:, j] & kf_valid
            if not new.any():
                continue
            obs_uv[new, j] = t_uv[new, l2]
            obs_xyz[new, j] = t_xyz[new, l2]
            mask[new, j] = True

    has_depth = np.linalg.norm(obs_xyz, axis=-1) > 0.2

    # loop-closure landmarks: scan every record slot for re-acquisitions —
    # a measured-frame gap ≥ lc_gap during which the landmark was mostly
    # out of view (a revisit, not a tracking dropout)
    lc_lm = np.zeros(l, bool)
    lc_events: list[tuple[int, int]] = []
    if lc_gap > 0 and rec_visible is not None:
        for slot in range(k):
            rows_all = np.nonzero(measured[:, slot])[0]
            if len(rows_all) < 2:
                continue
            for initf in np.unique(init_frame[rows_all, slot]):
                rows = rows_all[init_frame[rows_all, slot] == initf]
                if len(rows) < 2:
                    continue
                gaps = np.diff(rows)
                for gi in np.nonzero(gaps >= lc_gap)[0]:
                    r0, r1 = rows[gi], rows[gi + 1]
                    if rec_visible[r0 + 1:r1, slot].mean() < 0.3:
                        lc_events.append((int(r0), int(r1)))
                        li = ids.get((int(slot), int(initf)))
                        if li is not None and remap[li] >= 0:
                            lc_lm[remap[li]] = True

    lcp = _mine_lc_pose_factors(lc_events, measured, init_frame, z_xyz,
                                t_all, q_all, kf_indices, kf_valid)

    # odometry-chain factors between consecutive keyframes: the filter's
    # own relative motion (t in frame i, q_i⁻¹ ⊗ q_{i+1})
    kt, kq = t_all[kf_indices], q_all[kf_indices]
    if m > 1:
        kq_t = torch.as_tensor(kq)
        odo_t = qrotate(qconj(kq_t[:-1]),
                        torch.as_tensor(kt[1:] - kt[:-1])).numpy()
        odo_q = qprod(qconj(kq_t[:-1]), kq_t[1:]).numpy()
    else:
        odo_t = np.zeros((0, 3), np.float32)
        odo_q = np.zeros((0, 4), np.float32)
    # zero weight on factors touching padded/invalid keyframe slots
    odo_w = (kf_valid[:-1] & kf_valid[1:]).astype(np.float32)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    return BaProblem(
        obs_uv=put(obs_uv), mask=put(mask), kf_t=put(kt), kf_q=put(kq),
        points=put(points), obs_xyz=put(obs_xyz),
        mask_xyz=put(mask & has_depth),
        odo_t=put(odo_t.astype(np.float32)),
        odo_q=put(odo_q.astype(np.float32)), odo_w=put(odo_w),
        lc_lm=put(lc_lm),
        **({} if lcp is None else dict(zip(
            ("lcp_i", "lcp_j", "lcp_t", "lcp_q", "lcp_w", "lcp_info"),
            (put(a) for a in lcp)))),
    )


def _mine_lc_pose_factors(
    events: list[tuple[int, int]],  # (r0, r1) record rows of a revisit
    measured: np.ndarray,  # [F-1, K]
    init_frame: np.ndarray,  # [F-1, K]
    z_xyz: np.ndarray,  # [F-1, K, 3] camera-frame depth observations
    t_all: np.ndarray,  # [F, 3] filter trajectory
    q_all: np.ndarray,  # [F, 4]
    kf_indices: np.ndarray,  # [M]
    kf_valid: np.ndarray,  # [M]
    min_pts: int = 4,
    max_rmse: float = 0.05,
):
    """Keyframe-to-keyframe relative-pose factors from filter
    re-acquisitions: Kabsch on the landmarks co-measured at the two
    frames of a revisit event gives T_{f0→f1}; the frames map to their
    nearest keyframes with the filter's short pose hops composed in, and
    the strongest event per keyframe pair is kept. Returns (lcp_i, lcp_j,
    lcp_t, lcp_q, lcp_w, lcp_info) or None."""
    valid_pos = np.nonzero(np.asarray(kf_valid))[0]
    if len(valid_pos) < 2 or not events:
        return None
    kf_frames = np.asarray(kf_indices)[valid_pos]
    t_cpu, q_cpu = torch.as_tensor(t_all), torch.as_tensor(q_all)

    def rel(i: int, j: int):
        """Filter-estimated relative pose frame i → frame j."""
        qi = qconj(q_cpu[i])
        return qrotate(qi, t_cpu[j] - t_cpu[i]), qprod(qi, q_cpu[j])

    best: dict[tuple[int, int], tuple] = {}
    for r0, r1 in sorted(set(events)):
        co = (measured[r0] & measured[r1]
              & (init_frame[r0] == init_frame[r1])
              & (np.linalg.norm(z_xyz[r0], axis=-1) > 0.2)
              & (np.linalg.norm(z_xyz[r1], axis=-1) > 0.2))
        n = int(co.sum())
        if n < min_pts:
            continue
        p0 = torch.as_tensor(z_xyz[r0, co])
        p1 = torch.as_tensor(z_xyz[r1, co])
        fit = kabsch(p0, p1)
        if not bool(fit.ok) or float(fit.rmse) > max_rmse:
            continue
        cov = vo_covariance(fit.r, fit.t, p0, p1,
                            torch.ones(p0.shape[0], dtype=p0.dtype)).numpy()
        f0, f1 = r0 + 1, r1 + 1
        ia = int(valid_pos[np.argmin(np.abs(kf_frames - f0))])
        ib = int(valid_pos[np.argmin(np.abs(kf_frames - f1))])
        if ia == ib:
            continue
        fa, fb = int(kf_indices[ia]), int(kf_indices[ib])
        t_a0, q_a0 = rel(fa, f0)
        t_1b, q_1b = rel(f1, fb)
        q_k, t_k = r2q(fit.r), fit.t
        # T_{a→b} = T_{a→f0} ∘ T_{f0→f1} ∘ T_{f1→b}
        t_ab = t_a0 + qrotate(q_a0, t_k + qrotate(q_k, t_1b))
        q_ab = qnormalize(qprod(q_a0, qprod(q_k, q_1b)))
        key = (ia, ib) if ia < ib else (ib, ia)
        if ia > ib:  # factors in ascending (i, j) orientation: invert
            q_ab = qconj(q_ab)
            t_ab = -qrotate(q_ab, t_ab)
        if key not in best or best[key][0] < n:
            best[key] = (n, t_ab.numpy(), q_ab.numpy(),
                         sqrt_information(cov))
    if not best:
        return None
    keys = sorted(best)
    return (np.array([k[0] for k in keys], np.int32),
            np.array([k[1] for k in keys], np.int32),
            np.stack([best[k][1] for k in keys]).astype(np.float32),
            np.stack([best[k][2] for k in keys]).astype(np.float32),
            np.ones(len(keys), np.float32),
            np.stack([best[k][3] for k in keys]).astype(np.float32))
