"""Landmark track building across keyframes → BA factor graph.

Port of ``pre3_tpu/backend/tracks.py``: a fixed-capacity track table
matched keyframe to keyframe with the frontend's descriptor matcher (K2,
one launch per keyframe), producing the masked [M, L] observation
tensors of ``backend/ba.py``. Per keyframe: (1) match the track
descriptors to the keyframe's features, (2) record observations,
(3) spawn new tracks from unmatched features into free slots. The
reference's ``lax.scan`` is a host loop that reads nothing back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.backend.ba import BaProblem
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.camera import project, sr4000_camera
from pre3_tpu_torch.geometry.quaternion import qconj, qrotate
from pre3_tpu_torch.ops.matching import match_descriptors_auto
from pre3_tpu_torch.utils.topk import stable_topk


class TrackTable(NamedTuple):
    desc: torch.Tensor  # [L, D]
    active: torch.Tensor  # [L] bool
    point_w: torch.Tensor  # [L, 3] world-frame init (first observation)


def used_features(index: torch.Tensor, matched: torch.Tensor,
                  n: int) -> torch.Tensor:
    """[n] bool: feature j is used when the table row with the HIGHEST
    index among those whose best match is j is matched. The reference
    writes ``zeros.at[index].set(matched)``, whose duplicate indices
    carry mixed values (every inactive row still names some feature);
    XLA's CPU scatter lets the last row win. ``scatter_reduce(amax)`` of
    the row ids pins that rule on every device."""
    rows = torch.arange(index.shape[0], device=index.device)
    winner = torch.full((n,), -1, dtype=rows.dtype, device=index.device)
    winner = winner.scatter_reduce(0, index, rows, reduce="amax")
    return (winner >= 0) & matched[torch.clamp(winner, min=0)]


def build_tracks(
    kf_feats: Features,  # stacked over M keyframes
    kf_t: torch.Tensor,  # [M, 3] initial keyframe poses (world)
    kf_q: torch.Tensor,  # [M, 4]
    kf_valid: torch.Tensor,  # [M] bool
    max_tracks: int = 256,
    adds_per_frame: int = 64,
    ratio: float = 1.3,
    gate_px: float = 25.0,
):
    """Returns (obs_uv [M,L,2], obs_xyz [M,L,3], mask [M,L], table)."""
    m = kf_feats.uv.shape[0]
    l, dd = max_tracks, kf_feats.desc.shape[-1]
    dt, dev = kf_feats.xyz.dtype, kf_feats.xyz.device
    cam = sr4000_camera()  # hard-wired, as in the reference
    table = TrackTable(desc=torch.zeros((l, dd), dtype=dt, device=dev),
                       active=torch.zeros(l, dtype=torch.bool, device=dev),
                       point_w=torch.zeros((l, 3), dtype=dt, device=dev))
    uvs, xyzs, recs = [], [], []
    for i in range(m):
        feats = Features(*(x[i] for x in kf_feats))
        t_wc, q_wc, kfv = kf_t[i], kf_q[i], kf_valid[i]
        kf = feats.uv.shape[0]
        mt = match_descriptors_auto(table.desc, feats.desc,
                                    valid1=table.active, valid2=feats.valid,
                                    ratio=ratio)
        matched = mt.accepted & kfv
        obs_uv = feats.uv[mt.index]
        obs_xyz = feats.xyz[mt.index]
        has_depth = torch.linalg.vector_norm(obs_xyz, dim=-1) > 0.2
        # geometric gate: the track's world point reprojected through the
        # (initial) keyframe pose lands near the matched pixel
        p_cam = qrotate(qconj(q_wc), table.point_w - t_wc)
        pred = project(cam, p_cam)
        close = (torch.linalg.vector_norm(pred - obs_uv, dim=-1) < gate_px) & (
            p_cam[..., 2] > 0.2)
        matched = matched & close
        rec = matched & has_depth
        # refresh the descriptor on a match
        desc = torch.where(matched[:, None], feats.desc[mt.index], table.desc)

        # spawn new tracks from unmatched frame features
        used = used_features(mt.index, matched, kf)
        cand = feats.valid & ~used & (
            torch.linalg.vector_norm(feats.xyz, dim=-1) > 0.2) & kfv
        score = torch.where(cand, feats.score, -1.0)
        top_score, top_idx = stable_topk(score, adds_per_frame)
        slot_order = torch.sort(table.active.to(torch.int32),
                                stable=True).indices
        free = slot_order[:adds_per_frame]
        can_add = (top_score > 0) & ~table.active[free]
        add2 = can_add[:, None]
        p_w = t_wc + qrotate(q_wc, feats.xyz[top_idx])  # [A, 3]

        def put(field, new):
            out = field.clone()
            out[free] = torch.where(add2 if new.dim() > 1 else can_add, new,
                                    field[free])
            return out

        table = TrackTable(desc=put(desc, feats.desc[top_idx]),
                           active=put(table.active, can_add),
                           point_w=put(table.point_w, p_w))
        # the first observation of a spawned track is recorded too
        uvs.append(put(obs_uv, feats.uv[top_idx]))
        xyzs.append(put(obs_xyz, feats.xyz[top_idx]))
        recs.append(put(rec, can_add))
    return torch.stack(uvs), torch.stack(xyzs), torch.stack(recs), table


def make_ba_problem_from_tracks(
    kf_feats: Features,
    kf_t: torch.Tensor,
    kf_q: torch.Tensor,
    kf_valid: torch.Tensor,
    max_tracks: int = 256,
    min_obs: int = 2,
) -> BaProblem:
    """Tracks → masked BA problem; tracks seen in fewer than min_obs
    keyframes are dropped (unconstrained in BA)."""
    obs_uv, obs_xyz, mask, table = build_tracks(
        kf_feats, kf_t, kf_q, kf_valid, max_tracks=max_tracks)
    seen = torch.sum(mask, dim=0) >= min_obs
    mask = mask & seen[None]
    return BaProblem(obs_uv=obs_uv, mask=mask, kf_t=kf_t, kf_q=kf_q,
                     points=table.point_w, obs_xyz=obs_xyz, mask_xyz=mask)
