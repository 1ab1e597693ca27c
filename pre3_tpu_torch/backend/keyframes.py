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

``find_keyframes_vo`` is the offline pass itself (VO against the last
accepted keyframe, resumable through ``utils/cache.py::VoCache``), and
``export_keyframe_dataset`` writes its KeyFrames/ mirror dataset. The
reference's jitted pair VO is a step program (``utils/graphs.py``) keyed
by one frame's shapes and the pass's config: the last keyframe and the
candidate frame in its buffers (copied in from frames staged
``STAGE_ROWS`` at a time), ``vo_pair`` and the motion's angle and length
into its output row. On the card each computed pair is one replay of a
captured CUDA graph with K2 and K1 inside, and its output row comes back
to the host in one copy, the verdict read; on the CPU the same body runs
eagerly.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import torch

from pre3_tpu_torch.data.sr4000 import list_sequence
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.quaternion import q2v, qconj, qprod
from pre3_tpu_torch.geometry.se3 import Pose
from pre3_tpu_torch.utils.graphs import (
    STAGE_ROWS, Packing, StepProgram, program, shape_key,
)
from pre3_tpu_torch.vo.dead_reckoning import VoStep, vo_pair
from pre3_tpu_torch.vo.ransac import _draw_gumbel

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


def motion(t: torch.Tensor, q: torch.Tensor):
    """(rotation angle, translation length) of a VO increment, on its
    device, as the reference measures a candidate keyframe."""
    return torch.linalg.vector_norm(q2v(q)), torch.linalg.vector_norm(t)


def _pair_body(batch: int, min_inliers: int, frame: Packing, pout: Packing):
    """``find_keyframes_vo``'s program body: ``vo_pair`` from the last
    keyframe (``last``) to the candidate (``cur``), with the candidate's
    draws (``gumbel``) or the program's generator; the VoStep fields and
    the increment's ``motion`` into the output row."""

    def body(b, gens):
        s = vo_pair(Features(*frame.unpack(b["last"])),
                    Features(*frame.unpack(b["cur"])), gumbel=b["gumbel"],
                    generator=gens[0] if gens else None, batch=batch,
                    min_inliers=min_inliers)
        pout.pack((s.delta.t, s.delta.q, s.ok, s.n_inliers, s.n_matches,
                   s.cov, *motion(s.delta.t, s.delta.q)), b["out"])

    return body


def find_keyframes_vo(
    feats: Features,  # stacked over frames: [F, ...]
    rot_thresh_deg: float = ROT_THRESH_DEG,
    trans_thresh_m: float = TRANS_THRESH_M,
    vo_cache=None,
    batch: int = 1024,
    min_inliers: int = 8,
    gumbel: torch.Tensor | None = None,  # [F-1, batch, Kf]
    generator: torch.Generator | None = None,
) -> OfflineKeyframes:
    """Offline keyframe search with the reference's semantics: each
    candidate frame's VO is computed AGAINST THE LAST ACCEPTED KEYFRAME,
    not chained frame to frame, and the frame is accepted when a_rot ≥ 4°
    or ‖T‖ ≥ 0.05 m with a valid solution; frames whose VO fails are
    skipped. A host loop over the pair program (see the module
    docstring) that reads each pair's verdict back, as the reference
    does; a computed pair's VoStep is a host copy of its output row.
    ``vo_cache`` is a ``utils.cache.VoCache`` for resumable passes: a
    cached pair is read from disk and launches no kernel of the pair.
    Candidate frame i's RANSAC draws are ``gumbel[i-1]`` or are drawn
    from ``generator`` for every candidate, cached or not, as the
    reference splits its key for every candidate: a partly cached pass
    gives each computed pair the draws an uncached pass would."""
    if gumbel is None and generator is None:
        raise ValueError("find_keyframes_vo needs gumbel noise or a generator")
    n_frames, kf = feats.uv.shape[:2]
    dev = feats.uv.device
    rot_thresh = float(np.radians(rot_thresh_deg))
    gens = [] if gumbel is not None else [generator]
    frame = Packing(Features(*(x[0] for x in feats)))
    dt = feats.xyz.dtype
    pout = Packing(tuple(torch.empty(shape, dtype=d) for shape, d in (
        ((3,), dt), ((4,), dt), ((), torch.bool), ((), torch.int32),
        ((), torch.int32), ((6, 6), dt), ((), dt), ((), dt))))

    def make():
        bufs = dict(last=frame.rows(device=dev), cur=frame.rows(device=dev),
                    gumbel=None if gumbel is None else torch.empty_like(
                        gumbel[0]),
                    out=pout.rows(device=dev))
        return StepProgram("find_keyframes_vo", bufs, dev, len(gens))

    prog = program(("find_keyframes_vo", batch, min_inliers, len(gens),
                    shape_key(Features(*(x[0] for x in feats)),
                              None if gumbel is None else gumbel[0])), make)
    body = _pair_body(batch, min_inliers, frame, pout)
    rows = frame.rows(min(n_frames, STAGE_ROWS), device=dev)
    staged = held = None  # rows' first frame; the frame in ``last``

    def row(i: int) -> torch.Tensor:
        """Frame i's packed row, staging its block of frames first."""
        nonlocal staged
        lo = i - i % STAGE_ROWS
        if staged != lo:
            hi = min(n_frames, lo + STAGE_ROWS)
            frame.pack(Features(*(x[lo:hi] for x in feats)), rows[:hi - lo])
            staged = lo
        return rows[i - lo]

    def compute(last: int, i: int):
        """The pair (last, i) through the program: its VoStep and the
        increment's motion, as views of one host copy of the output
        row."""
        nonlocal held
        b = prog.buffers
        if held != last:
            b["last"].copy_(row(last))
            held = last
        b["cur"].copy_(row(i))
        if gumbel is not None:
            b["gumbel"].copy_(gumbel[i - 1])
        prog.run(None, body, gens)
        t, q, ok, n_inl, n_match, cov, ang, dist = pout.unpack(
            b["out"].to("cpu", copy=True))  # the verdict read
        return VoStep(Pose(t, q), ok, n_inl, n_match, cov), (ang, dist)

    last = 0
    indices = [0]
    deltas_t = [np.zeros(3, np.float32)]
    deltas_q = [np.array([1.0, 0, 0, 0], np.float32)]
    n_calls = 0
    for i in range(1, n_frames):
        measured = []

        def computed(last=last, i=i) -> VoStep:
            step, m = compute(last, i)
            measured.append(m)
            return step

        step = (vo_cache.get(last, i, computed) if vo_cache is not None
                else computed())
        n_calls += 1
        if not measured:  # read from the cache: draw and measure as above
            if generator is not None:
                _draw_gumbel((batch, kf), generator, device=dev)
            measured.append(motion(step.delta.t, step.delta.q))
        if not bool(step.ok):
            continue
        ang, dist = (float(x) for x in measured[0])
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


def export_keyframe_dataset(
    indices,
    out_dir: str,
    src_dir: str | None = None,
    feats: Features | None = None,
    deltas: OfflineKeyframes | None = None,
) -> str:
    """Write the keyframe mirror dataset (the reference's renumber-and-copy
    into KeyFrames/): accepted raw `d1_*.dat` frames from `src_dir` are
    copied as `d1_%04d.dat` with NEW consecutive numbering, per-keyframe
    features (if given, stacked over frames, on any device) are saved as
    npz, and `manifest.json` records the new→original index map plus
    inter-keyframe VO increments — the same files and keys as the
    reference's. Returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    indices = [int(i) for i in indices]
    if src_dir is not None:
        paths = list_sequence(src_dir)
        for new, orig in enumerate(indices):
            shutil.copyfile(
                paths[orig], os.path.join(out_dir, f"d1_{new + 1:04d}.dat"))
    if feats is not None:
        sel = torch.as_tensor(indices, dtype=torch.int64)
        host = Features(*(x[sel.to(x.device)].cpu().numpy() for x in feats))
        for new in range(len(indices)):
            with open(os.path.join(
                    out_dir, f"features_{new + 1:04d}.npz"), "wb") as f:
                np.savez(f, **{k: getattr(host, k)[new]
                               for k in Features._fields})
    manifest = {
        "original_indices": indices,
        "rot_thresh_deg": ROT_THRESH_DEG,
        "trans_thresh_m": TRANS_THRESH_M,
    }
    if deltas is not None:
        manifest["delta_t"] = deltas.delta_t.tolist()
        manifest["delta_q"] = deltas.delta_q.tolist()
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir
