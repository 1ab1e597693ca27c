"""Landmark track building across keyframes → BA factor graph.

Port of ``pre3_tpu/backend/tracks.py``: a fixed-capacity track table
matched keyframe to keyframe with the frontend's descriptor matcher (K2,
one launch per keyframe), producing the masked [M, L] observation
tensors of ``backend/ba.py``. Per keyframe: (1) match the track
descriptors to the keyframe's features, (2) record observations,
(3) spawn new tracks from unmatched features into free slots.

The reference's jitted ``lax.scan`` over the keyframes is a step program
(``utils/graphs.py``) keyed by ``max_tracks``, ``adds_per_frame``,
``ratio``, ``gate_px`` and one keyframe's shapes, never by the keyframe
count: the track table is its carry (one byte row, updated in place),
one keyframe's features, pose and validity its input row (staged
``STAGE_ROWS`` keyframes at a time), the keyframe's observations its
output row. On the card each keyframe is one replay of a captured CUDA
graph with K2 inside; on the CPU the same body runs eagerly. Nothing is
read back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.backend.ba import BaProblem
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.camera import project, sr4000_camera
from pre3_tpu_torch.geometry.quaternion import qconj, qrotate
from pre3_tpu_torch.ops.matching import match_descriptors_auto
from pre3_tpu_torch.utils.graphs import (
    STAGE_ROWS, Packing, StepProgram, load, program, shape_key,
)
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


def track_step(table: TrackTable, feats: Features, t_wc, q_wc, kfv,
               adds_per_frame: int, ratio: float, gate_px: float):
    """One keyframe of ``build_tracks`` (the body of the reference's
    scan): (the new table, (obs_uv [L, 2], obs_xyz [L, 3], rec [L]))."""
    kf = feats.uv.shape[0]
    cam = sr4000_camera()  # hard-wired, as in the reference
    mt = match_descriptors_auto(table.desc, feats.desc, valid1=table.active,
                                valid2=feats.valid, ratio=ratio)
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
    slot_order = torch.sort(table.active.to(torch.int32), stable=True).indices
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
    return table, (put(obs_uv, feats.uv[top_idx]),
                   put(obs_xyz, feats.xyz[top_idx]), put(rec, can_add))


def _tracks_body(adds_per_frame: int, ratio: float, gate_px: float,
                 pin: Packing, table: Packing, pout: Packing):
    """``build_tracks``' program body: one keyframe's features, pose and
    validity from the input row, ``track_step`` on the carried table, the
    new table back into the carry and the observations into the output
    row."""

    def body(b, gens):
        feats, t_wc, q_wc, kfv = pin.unpack(b["inp"])
        carry = TrackTable(*table.unpack(b["table"]))
        new, obs = track_step(carry, Features(*feats), t_wc, q_wc, kfv,
                              adds_per_frame, ratio, gate_px)
        pout.pack(obs, b["out"])
        load(tuple(carry), tuple(new))

    return body


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
    """Returns (obs_uv [M,L,2], obs_xyz [M,L,3], mask [M,L], table): one
    run of the tracks program per keyframe (see the module docstring);
    the observations are views of the call's own output rows, the table a
    copy of the final carry."""
    m = kf_feats.uv.shape[0]
    dev = kf_feats.xyz.device
    one = (Features(*(x[0] for x in kf_feats)), kf_t[0], kf_q[0],
           kf_valid[0])
    l, dt = max_tracks, kf_feats.xyz.dtype
    pin = Packing(one)
    table = Packing(TrackTable(  # all zeros: no track active
        desc=torch.empty((l, kf_feats.desc.shape[-1]),
                         dtype=torch.promote_types(kf_feats.desc.dtype, dt)),
        active=torch.empty(l, dtype=torch.bool),
        point_w=torch.empty((l, 3), dtype=dt)))
    pout = Packing((torch.empty((l, 2), dtype=kf_feats.uv.dtype),
                    torch.empty((l, 3), dtype=dt),
                    torch.empty(l, dtype=torch.bool)))

    def make():
        bufs = dict(table=table.rows(device=dev), inp=pin.rows(device=dev),
                    out=pout.rows(device=dev))
        return StepProgram("build_tracks", bufs, dev, carry=("table",))

    prog = program(("build_tracks", max_tracks, adds_per_frame, ratio,
                    gate_px, shape_key(one)), make)
    prog.buffers["table"].zero_()
    body = _tracks_body(adds_per_frame, ratio, gate_px, pin, table, pout)
    in_rows = pin.rows(min(m, STAGE_ROWS), device=dev)
    out_rows = pout.rows(m, device=dev)
    for lo in range(0, m, STAGE_ROWS):
        hi = min(m, lo + STAGE_ROWS)
        rows = in_rows[:hi - lo]
        pin.pack((Features(*(x[lo:hi] for x in kf_feats)), kf_t[lo:hi],
                  kf_q[lo:hi], kf_valid[lo:hi]), rows)
        prog.run_rows([None] * (hi - lo), lambda _: body, rows,
                      out_rows[lo:hi])
    obs_uv, obs_xyz, rec = pout.unpack(out_rows)
    final = TrackTable(*table.unpack(prog.buffers["table"].clone()))
    return obs_uv, obs_xyz, rec, final


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
