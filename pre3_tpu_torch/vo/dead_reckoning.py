"""RANSAC dead-reckoning visual odometry over a sequence.

Port of ``pre3_tpu/vo/dead_reckoning.py``. The reference chains the
frame-to-frame fits with one jitted ``lax.scan``; here each pair is one
step of a step program (``utils/graphs.py``): on the card one replay of
a captured CUDA graph (K2, the Gumbel top-k sampling, Kabsch, K1, the
refit and the pose chaining), eager on the CPU. Nothing is read back to
the host. Failure semantics are the reference's: a pair without a valid
solution contributes identity motion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.quaternion import qnormalize, qprod, qrotate, r2q
from pre3_tpu_torch.geometry.se3 import Pose
from pre3_tpu_torch.ops.matching import match_descriptors_auto
from pre3_tpu_torch.utils.graphs import (
    STAGE_ROWS, Packing, StepProgram, empty_like_tree, load, program,
    shape_key,
)
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


def _pair_body(batch: int, ratio: float, min_inliers: int, pin: Packing,
               pout: Packing):
    """One pair of ``run_sequence`` over a program's buffers: frame i+1
    and the pair's noise from the input row, frame i and the pose of
    frame i from the carry, ``vo_pair``, the chained pose of frame i+1
    into the carry and, with the pair's ok and inliers, into the output
    row; frame i+1 into the carry."""

    def body(b, gens):
        cur, gumbel = pin.unpack(b["inp"])
        s = vo_pair(Features(*b["prev"]), Features(*cur), gumbel=gumbel,
                    generator=gens[0] if gens else None, batch=batch,
                    ratio=ratio, min_inliers=min_inliers)
        t_w, q_w = b["t"], b["q"]
        dt = torch.where(s.ok, s.delta.t, torch.zeros_like(t_w))
        dq = torch.where(s.ok, s.delta.q, b["unit_q"])
        t_new = t_w + qrotate(q_w, dt)
        q_new = qnormalize(qprod(q_w, dq))
        pout.pack((t_new, q_new, s.ok, s.n_inliers), b["out"])
        t_w.copy_(t_new)
        q_w.copy_(q_new)
        load(b["prev"], cur)

    return body


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
    keeps the previous pose (identity motion step). The pairs are one
    step program's runs (see the module docstring), keyed by one pair's
    shapes: per pair the host copies frame i+1 and its noise, packed
    ``STAGE_ROWS`` pairs at a time, into the program's input row, and
    the output row into the call's own storage.
    """
    n_frames, k = feats.valid.shape
    device, dtype = feats.xyz.device, feats.xyz.dtype
    if gumbel is None and generator is None:
        raise ValueError("run_sequence needs gumbel noise or a generator")
    if gumbel is not None and tuple(gumbel.shape) != (n_frames - 1, batch, k):
        raise ValueError(
            f"gumbel must have shape {(n_frames - 1, batch, k)}, "
            f"got {tuple(gumbel.shape)}")
    gens = [] if gumbel is not None else [generator]
    pick = lambda x, lo, hi: None if x is None else x[lo:hi]  # noqa: E731
    one = (Features(*(x[0] for x in feats)),
           None if gumbel is None else gumbel[0])
    pin = Packing(one)
    origin = Trajectory(
        t=torch.zeros(3, dtype=dtype, device=device),
        q=torch.zeros(4, dtype=dtype, device=device),
        ok=torch.ones((), dtype=torch.bool, device=device),
        n_inliers=torch.zeros((), dtype=torch.int32, device=device))
    origin.q[0].fill_(1.0)  # `q[0] = 1.0` would be a synced copy
    pout = Packing(tuple(origin))

    def make():
        bufs = dict(prev=empty_like_tree(one[0]), t=torch.empty_like(origin.t),
                    q=torch.empty_like(origin.q), unit_q=origin.q.clone(),
                    inp=pin.rows(device=device), out=pout.rows(device=device))
        return StepProgram("run_sequence", bufs, device, len(gens),
                           carry=("prev", "t", "q"))

    prog = program(("run_sequence", batch, ratio, min_inliers, len(gens),
                    shape_key(one)), make)
    b = prog.buffers
    load((b["prev"], b["t"], b["q"]), (one[0], origin.t, origin.q))
    body = _pair_body(batch, ratio, min_inliers, pin, pout)
    n_pairs = n_frames - 1
    in_rows = pin.rows(min(n_pairs, STAGE_ROWS), device=device)
    out_rows = pout.rows(n_pairs, device=device)
    for lo in range(0, n_pairs, STAGE_ROWS):
        hi = min(n_pairs, lo + STAGE_ROWS)
        rows = in_rows[:hi - lo]
        pin.pack((Features(*(x[lo + 1:hi + 1] for x in feats)),
                  pick(gumbel, lo, hi)), rows)
        prog.run_rows([None] * (hi - lo), lambda _: body, rows,
                      out_rows[lo:hi], gens)
    return Trajectory(*(torch.cat([o[None], x]) for o, x in
                        zip(origin, pout.unpack(out_rows))))
