"""Keyframe selection.

Port of ``pre3_tpu/backend/keyframes.py`` (the offline keyframing pass):
a frame becomes a keyframe when its motion since the last keyframe
exceeds a rotation or translation threshold (a_rot ≥ 4° or ‖T‖ ≥ 0.05 m)
and its pose is valid. Selection is a mask + gather over a stacked
sequence with a fixed ``max_keyframes`` capacity.

The reference's ``lax.scan`` is a sequential greedy pass over a [F, 7]
trajectory; here it is a host loop over CPU tensors (one copy of the
trajectory to the host), in f32 as the reference compares. The
compaction that follows is the reference's stable sort.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.quaternion import q2v, qconj, qprod
from pre3_tpu_torch.vo.dead_reckoning import vo_pair

ROT_THRESH_DEG = 4.0
TRANS_THRESH_M = 0.05


class KeyframeSet(NamedTuple):
    indices: torch.Tensor  # [M] int32 frame indices (padded with the last)
    valid: torch.Tensor  # [M] bool
    n: torch.Tensor  # [] int32


def select_keyframes(
    traj_t: torch.Tensor,  # [F, 3] VO/SLAM trajectory positions
    traj_q: torch.Tensor,  # [F, 4]
    ok: torch.Tensor,  # [F] per-frame validity
    max_keyframes: int = 16,
    rot_thresh_deg: float = ROT_THRESH_DEG,
    trans_thresh_m: float = TRANS_THRESH_M,
) -> KeyframeSet:
    """Greedy sequential selection: frame f is accepted when its motion
    relative to the LAST ACCEPTED keyframe crosses a threshold. The
    result lies on the trajectory's device."""
    dev = traj_t.device
    t_all, q_all = traj_t.detach().cpu(), traj_q.detach().cpu()
    ok_all = ok.detach().cpu().numpy()
    n_frames = t_all.shape[0]
    rot_thresh = float(np.float32(np.radians(rot_thresh_deg)))
    accepted = np.zeros(n_frames, bool)
    last_t, last_q, count = t_all[0], q_all[0], 1
    for f in range(n_frames):
        ang = torch.linalg.vector_norm(q2v(qprod(qconj(last_q), q_all[f])))
        dist = torch.linalg.vector_norm(t_all[f] - last_t)
        if ok_all[f] and (bool(ang >= rot_thresh)
                          or bool(dist >= trans_thresh_m)) and (
                count < max_keyframes):
            accepted[f] = True
            last_t, last_q, count = t_all[f], q_all[f], count + 1
    accepted[0] = True  # frame 0 is always a keyframe

    # compact to the fixed capacity: accepted frames first, padded
    acc = torch.as_tensor(accepted)
    order = torch.sort((~acc).to(torch.int32), stable=True).indices
    indices = order[:max_keyframes]
    valid = acc[indices]
    indices = torch.sort(torch.where(valid, indices, n_frames - 1)).values
    valid = torch.flip(torch.sort(valid.to(torch.int32)).values, [0]) > 0
    return KeyframeSet(indices=indices.to(torch.int32).to(dev),
                       valid=valid.to(dev),
                       n=torch.tensor(int(accepted.sum()), dtype=torch.int32
                                      ).to(dev))


class OfflineKeyframes(NamedTuple):
    """Result of the offline pass: accepted frame indices plus the VO
    increment of each accepted keyframe relative to the PREVIOUS keyframe."""

    indices: np.ndarray  # [M] int
    delta_t: np.ndarray  # [M, 3] (zeros for the first keyframe)
    delta_q: np.ndarray  # [M, 4]
    n_vo_calls: int


def find_keyframes_vo(
    feats: Features,  # stacked over frames: [F, ...]
    rot_thresh_deg: float = ROT_THRESH_DEG,
    trans_thresh_m: float = TRANS_THRESH_M,
    batch: int = 1024,
    min_inliers: int = 8,
    gumbel: torch.Tensor | None = None,  # [F-1, batch, Kf]
    generator: torch.Generator | None = None,
) -> OfflineKeyframes:
    """Offline keyframe search with the reference's semantics: each
    candidate frame's VO is computed AGAINST THE LAST ACCEPTED KEYFRAME,
    not chained frame to frame, and the frame is accepted when a_rot ≥ 4°
    or ‖T‖ ≥ 0.05 m with a valid solution; frames whose VO fails are
    skipped. A host loop over ``vo_pair`` that reads each pair's verdict
    back, as the reference does. Candidate frame i's RANSAC draws are
    ``gumbel[i-1]`` or come from ``generator``. (The reference's resumable
    VO cache comes with ``utils/cache.py``, which is not ported.)"""
    n_frames = feats.uv.shape[0]
    rot_thresh = float(np.radians(rot_thresh_deg))
    frame = lambda i: Features(*(x[i] for x in feats))  # noqa: E731
    last = 0
    indices = [0]
    deltas_t = [np.zeros(3, np.float32)]
    deltas_q = [np.array([1.0, 0, 0, 0], np.float32)]
    n_calls = 0
    for i in range(1, n_frames):
        step = vo_pair(frame(last), frame(i),
                       gumbel=None if gumbel is None else gumbel[i - 1],
                       generator=generator, batch=batch,
                       min_inliers=min_inliers)
        n_calls += 1
        if not bool(step.ok):
            continue
        ang = float(torch.linalg.vector_norm(q2v(step.delta.q)))
        dist = float(torch.linalg.vector_norm(step.delta.t))
        if ang >= rot_thresh or dist >= trans_thresh_m:
            indices.append(i)
            deltas_t.append(step.delta.t.cpu().numpy())
            deltas_q.append(step.delta.q.cpu().numpy())
            last = i
    return OfflineKeyframes(
        indices=np.asarray(indices, np.int64),
        delta_t=np.stack(deltas_t), delta_q=np.stack(deltas_q),
        n_vo_calls=n_calls,
    )
