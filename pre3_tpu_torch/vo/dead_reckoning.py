"""RANSAC dead-reckoning visual odometry over a sequence.

Port of ``pre3_tpu/vo/dead_reckoning.py``. The reference chains the
frame-to-frame fits with one ``lax.scan``; here it is a Python loop over
frame pairs that never reads a value back to the host, so every launch of
the sequence is queued without waiting on the card. Failure semantics are
the reference's: a pair without a valid solution contributes identity
motion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.quaternion import qnormalize, qprod, qrotate, r2q
from pre3_tpu_torch.geometry.se3 import Pose
from pre3_tpu_torch.ops.matching import match_descriptors_auto
from pre3_tpu_torch.vo.covariance import vo_covariance
from pre3_tpu_torch.vo.ransac import ransac_rigid


class VoStep(NamedTuple):
    delta: Pose  # camera k-1 ← camera k rigid motion (T_c{k-1}_ck)
    ok: torch.Tensor  # [] bool
    n_inliers: torch.Tensor  # [] int32
    n_matches: torch.Tensor  # [] int32
    cov: torch.Tensor  # [6, 6] covariance of [dt, dω] (zeros: not computed)


def vo_pair(
    f1: Features,
    f2: Features,
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    batch: int = 1024,
    ratio: float = 1.3,
    min_inliers: int = 8,
    with_covariance: bool = False,
    range_weighted_refit: bool = False,
) -> VoStep:
    """Estimate the rigid motion between two feature sets.

    Returns T_c1_c2: p_c1 = R·p_c2 + t for a static scene — the pose of
    camera 2 expressed in camera 1. ``gumbel`` [batch, K] or ``generator``
    supplies RANSAC's sampling noise (see vo/ransac.py). With
    ``with_covariance``, ``cov`` is the IFT covariance of the increment
    (vo/covariance.py), the EKF's process noise; otherwise zeros.
    """
    m = match_descriptors_auto(
        f1.desc, f2.desc, valid1=f1.valid, valid2=f2.valid, ratio=ratio
    )
    p1 = f1.xyz
    p2 = f2.xyz[m.index]
    valid = m.accepted & f1.valid & f2.valid[m.index]
    res = ransac_rigid(
        p1, p2, valid, batch=batch, min_inliers=min_inliers,
        range_weighted_refit=range_weighted_refit, gumbel=gumbel,
        generator=generator,
    )
    if with_covariance:
        cov = vo_covariance(res.r, res.t, p1, p2, res.inliers.to(p1.dtype))
    else:
        cov = torch.zeros((6, 6), dtype=p1.dtype, device=p1.device)
    return VoStep(
        delta=Pose(t=res.t, q=r2q(res.r)), ok=res.ok,
        n_inliers=res.n_inliers,
        n_matches=torch.sum(valid, dtype=torch.int32),
        cov=cov,
    )


class Trajectory(NamedTuple):
    t: torch.Tensor  # [F, 3]
    q: torch.Tensor  # [F, 4]
    ok: torch.Tensor  # [F] bool (step validity; frame 0 is True)
    n_inliers: torch.Tensor  # [F] int32


def run_sequence(
    feats: Features,  # stacked: every field has leading axis F
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    batch: int = 1024,
    ratio: float = 1.3,
    min_inliers: int = 8,
) -> Trajectory:
    """Chain VO over a stacked feature sequence.

    gumbel [F-1, batch, K]: RANSAC's sampling noise for each pair, or a
    ``generator`` on the features' device to draw it. An invalid pair
    keeps the previous pose (identity motion step).
    """
    n_frames, k = feats.valid.shape
    device, dtype = feats.xyz.device, feats.xyz.dtype
    if gumbel is None and generator is None:
        raise ValueError("run_sequence needs gumbel noise or a generator")
    if gumbel is not None and tuple(gumbel.shape) != (n_frames - 1, batch, k):
        raise ValueError(
            f"gumbel must have shape {(n_frames - 1, batch, k)}, "
            f"got {tuple(gumbel.shape)}")

    t_w = torch.zeros(3, dtype=dtype, device=device)
    q_w = torch.zeros(4, dtype=dtype, device=device)
    q_w[0].fill_(1.0)  # a kernel argument: `q_w[0] = 1.0` would be a synced copy
    zero_t, unit_q = t_w, q_w
    ts, qs, oks, nis = [t_w], [q_w], [], []
    for i in range(1, n_frames):
        prev = Features(*(x[i - 1] for x in feats))
        cur = Features(*(x[i] for x in feats))
        s = vo_pair(prev, cur,
                    gumbel=None if gumbel is None else gumbel[i - 1],
                    generator=generator, batch=batch, ratio=ratio,
                    min_inliers=min_inliers)
        dt = torch.where(s.ok, s.delta.t, zero_t)
        dq = torch.where(s.ok, s.delta.q, unit_q)
        t_w = t_w + qrotate(q_w, dt)
        q_w = qnormalize(qprod(q_w, dq))
        ts.append(t_w)
        qs.append(q_w)
        oks.append(s.ok)
        nis.append(s.n_inliers)
    return Trajectory(
        t=torch.stack(ts),
        q=torch.stack(qs),
        ok=torch.stack([torch.ones((), dtype=torch.bool, device=device), *oks]),
        n_inliers=torch.stack(
            [torch.zeros((), dtype=torch.int32, device=device), *nis]),
    )
