"""Hypothesis-parallel RANSAC VO over a process mesh.

Port of ``pre3_tpu/parallel/vo_sharded.py``: the hypothesis batch of
``vo/ransac.py::ransac_rigid`` spread over the mesh axis "hyp". Every
rank holds the same global Gumbel draws [B, N] and takes its contiguous
B/n slice of the hypotheses; it solves their Kabsch fits and scores them
with ``score_hypotheses`` (kernel K1 on the card, at (B/n, N)). The
winner is the first maximum of the score in global hypothesis order, as
``argmax`` picks it: the shards are contiguous in rank order, so one
all-gather of each rank's best (score, fit) and a first maximum over the
ranks find it. Every rank then refits on the winner's inliers, as
``ransac_rigid`` does. Nothing is read back to the host.
"""

from __future__ import annotations

import torch

from pre3_tpu_torch.ops.ransac_score import score_hypotheses
from pre3_tpu_torch.parallel.mesh import Mesh, all_gather, shard_batch
from pre3_tpu_torch.vo.ransac import (
    RansacResult, _draw_gumbel, _sample_hypotheses,
)
from pre3_tpu_torch.vo.rigid import kabsch


def sharded_ransac_rigid(
    mesh: Mesh,
    p1: torch.Tensor,  # [N, 3]
    p2: torch.Tensor,  # [N, 3]
    valid: torch.Tensor,  # [N] bool
    batch: int = 2048,
    sample_size: int = 4,
    support_threshold: float = 1e-3,
    min_inliers: int = 6,
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    axis: str = "hyp",
) -> RansacResult:
    """``ransac_rigid`` with the hypothesis batch sharded over ``axis``.

    ``gumbel`` [batch, N], the same on every rank, or a ``generator``
    seeded the same on every rank, supplies the sampling noise. The
    batch must divide over the axis. Identical math to ransac_rigid with
    a fixed ``support_threshold`` and no range weighting: at one rank
    the result is ransac_rigid's to the bit."""
    n = p1.shape[0]
    device = p1.device
    if gumbel is None:
        if generator is None:
            raise ValueError(
                "sharded_ransac_rigid needs gumbel noise or a generator")
        gumbel = _draw_gumbel((batch, n), generator, device=device)
    if tuple(gumbel.shape) != (batch, n):
        raise ValueError(
            f"gumbel must have shape {(batch, n)}, got {tuple(gumbel.shape)}")
    thr = torch.as_tensor(support_threshold, dtype=torch.float32,
                          device=device)

    # sampling is row-wise: sampling the slice equals slicing the samples
    g_local = shard_batch(mesh, gumbel, axis)
    idx = _sample_hypotheses(g_local, valid, sample_size)  # [B/n, S]
    fits = kabsch(p1[idx], p2[idx])
    support, err = score_hypotheses(
        fits.r.contiguous(), fits.t.contiguous(), p1.contiguous(),
        p2.contiguous(), valid.contiguous(), thr,
    )
    score = support.to(torch.float32) - err / (err + 1.0)
    score = torch.where(fits.ok, score, -1.0)
    best = torch.argmax(score).reshape(1)  # first maximum of the slice
    # each rank's best as one row: score, support, r, t
    row = torch.cat([
        torch.index_select(score, 0, best),
        torch.index_select(support, 0, best).to(torch.float32),
        torch.index_select(fits.r, 0, best).reshape(9),
        torch.index_select(fits.t, 0, best).reshape(3),
    ])
    rows = all_gather(mesh, row[None], axis)  # [n_ranks, 14]
    # shards are contiguous in rank order: the first maximum over ranks
    # is the global first maximum
    win = torch.argmax(rows[:, 0]).reshape(1)
    w_row = torch.index_select(rows, 0, win)[0]
    # fresh (aligned) copies, so the products below run as ransac_rigid's
    r_b, t_b = w_row[2:11].reshape(3, 3).clone(), w_row[11:14].clone()

    pred_b = p2 @ r_b.T + t_b
    resid2_b = torch.sum((pred_b - p1) ** 2, dim=-1)
    w = ((resid2_b < thr) & valid).to(p1.dtype)
    refit = kabsch(p1, p2, w)
    pred = torch.einsum("ij,nj->ni", refit.r, p2) + refit.t
    resid2 = torch.sum((pred - p1) * (pred - p1), dim=-1)
    inl = (resid2 < thr) & valid
    n_inl = torch.sum(inl, dtype=torch.int32)
    ok = refit.ok & (n_inl >= min_inliers)
    return RansacResult(
        r=refit.r, t=refit.t, inliers=inl, n_inliers=n_inl, ok=ok,
        rmse=refit.rmse, best_support=w_row[1].to(torch.int32),
    )
