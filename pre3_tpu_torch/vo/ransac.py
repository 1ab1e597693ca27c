"""Batch-parallel RANSAC rigid-motion estimation (frame-to-frame VO).

Port of ``pre3_tpu/vo/ransac.py``: draw all B minimal samples at once
(Gumbel top-k, without replacement, ∝ validity), fit B Kabsch hypotheses
with the batched closed-form SVD, score every hypothesis against every
match (kernel K1 on the card), take the best and refit on its inliers.

JAX's threefry draws cannot be reproduced in torch, so the Gumbel noise is
an input: pass ``gumbel`` [B, N] (the parity tests inject the reference's
own draws) or a ``generator`` on the inputs' device. Nothing here reads a
value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pre3_tpu_torch.ops.ransac_score import score_hypotheses
from pre3_tpu_torch.utils.topk import stable_topk
from pre3_tpu_torch.vo.rigid import kabsch


class RansacResult(NamedTuple):
    r: torch.Tensor  # [3, 3] rotation: frame2 → frame1
    t: torch.Tensor  # [3] translation
    inliers: torch.Tensor  # [N] bool — support of the refit solution
    n_inliers: torch.Tensor  # [] int32
    ok: torch.Tensor  # [] bool — valid solution (enough support, sane fit)
    rmse: torch.Tensor  # [] float — refit inlier RMS residual
    best_support: torch.Tensor  # [] int32 — winning hypothesis support


def _draw_gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise −log(−log U) from an explicit generator."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _sample_hypotheses(gumbel: torch.Tensor, valid: torch.Tensor,
                       sample_size: int) -> torch.Tensor:
    """[B, S] match indices, drawn ∝ validity: Gumbel-top-k per hypothesis
    gives samples without replacement."""
    logits = torch.where(valid, 0.0, -torch.inf)[None, :]  # [1, N]
    _, idx = stable_topk(logits + gumbel, sample_size)
    return idx


def ransac_rigid(
    p1: torch.Tensor,  # [N, 3] frame-1 points
    p2: torch.Tensor,  # [N, 3] frame-2 points (matched rows)
    valid: torch.Tensor,  # [N] bool
    batch: int = 1024,
    sample_size: int = 4,
    support_threshold: torch.Tensor | float | None = None,
    min_inliers: int = 6,
    range_weighted_refit: bool = False,
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> RansacResult:
    """Estimate (R, t) with p1 ≈ R·p2 + t from masked matched 3D points.

    support_threshold: squared-distance inlier gate in m². Default is the
    reference's scene-scaled gate 0.001·dist(nearest valid point in frame
    2), kept as a device tensor.

    range_weighted_refit: weight the final Kabsch refit by 1/‖p‖²; inlier
    gating stays binary.

    gumbel [batch, N]: the sampling noise; if absent it is drawn from
    ``generator``.
    """
    n = p1.shape[0]
    device = p1.device
    if support_threshold is None:
        d2 = torch.sum(p2 * p2, dim=-1)
        d2 = torch.where(valid, d2, torch.inf)
        support_threshold = 0.001 * torch.sqrt(torch.amin(d2))
    if isinstance(support_threshold, torch.Tensor):
        thr = support_threshold.to(device=device, dtype=torch.float32)
    else:  # a fill on the device: no host copy, no sync
        thr = torch.full((), float(support_threshold), dtype=torch.float32,
                         device=device)
    if gumbel is None:
        if generator is None:
            raise ValueError("ransac_rigid needs gumbel noise or a generator")
        gumbel = _draw_gumbel((batch, n), generator, device=device)
    if tuple(gumbel.shape) != (batch, n):
        raise ValueError(
            f"gumbel must have shape {(batch, n)}, got {tuple(gumbel.shape)}")

    idx = _sample_hypotheses(gumbel, valid, sample_size)  # [B, S]
    fits = kabsch(p1[idx], p2[idx])  # batched over B

    support, err = score_hypotheses(
        fits.r.contiguous(), fits.t.contiguous(), p1.contiguous(),
        p2.contiguous(), valid.contiguous(), thr,
    )
    # best = max support, ties broken by min error — a lexicographic score
    score = support.to(torch.float32) - err / (err + 1.0)
    score = torch.where(fits.ok, score, -1.0)
    best = torch.argmax(score).reshape(1)  # first maximum, stays on device

    # Recompute the winning hypothesis's inlier set and refit on it with
    # masked weights.
    r_b = torch.index_select(fits.r, 0, best)[0]
    t_b = torch.index_select(fits.t, 0, best)[0]
    pred_b = p2 @ r_b.T + t_b
    resid2_b = torch.sum((pred_b - p1) ** 2, dim=-1)
    w = ((resid2_b < thr) & valid).to(p1.dtype)
    if range_weighted_refit:
        w = w / torch.clamp(torch.sum(p2 * p2, dim=-1), min=0.25)
    refit = kabsch(p1, p2, w)
    pred = torch.einsum("ij,nj->ni", refit.r, p2) + refit.t
    resid2 = torch.sum((pred - p1) * (pred - p1), dim=-1)
    inl = (resid2 < thr) & valid
    n_inl = torch.sum(inl, dtype=torch.int32)
    ok = refit.ok & (n_inl >= min_inliers)
    return RansacResult(
        r=refit.r, t=refit.t, inliers=inl, n_inliers=n_inl, ok=ok,
        rmse=refit.rmse,
        best_support=torch.index_select(support, 0, best)[0],
    )
