"""Descriptor matching: squared-distance matrix + Lowe ratio test.

Port of the plain path of ``pre3_tpu/ops/matching.py``: the [N1, N2]
squared-distance matrix is one matmul (|a|² + |b|² − 2a·b), followed by a
best/second-best reduction and the ratio test (accept when
best·ratio < second, on squared distances).

The reference's streaming Pallas matcher (kernel K2, ``_match_kernel``)
is not ported yet. ``match_descriptors_auto`` therefore raises on a CUDA
tensor above K2's cutover instead of quietly running the plain path there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e30

# The reference's cutover to the streaming kernel K2 (padded problem
# ≥ 2048², pre3_tpu/ops/matching.py:217). The H100 cutover is to be
# measured when K2 is ported.
_K2_MIN_ELEMS = 2048 * 2048


class Matches(NamedTuple):
    index: torch.Tensor  # [N1] int64 — best column in d2 per row of d1
    dist2: torch.Tensor  # [N1] float32 — best squared distance
    dist2_second: torch.Tensor  # [N1] float32 — runner-up squared distance
    accepted: torch.Tensor  # [N1] bool — ratio test + validity


def _pairwise_dist2(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [N1, N2] via the matmul identity. Full f32:
    the package disables TF32 (pre3_tpu_torch/__init__.py)."""
    n1 = torch.sum(d1 * d1, dim=-1, keepdim=True)
    n2 = torch.sum(d2 * d2, dim=-1, keepdim=True).transpose(-1, -2)
    g = torch.matmul(d1, d2.transpose(-1, -2))
    return torch.clamp(n1 + n2 - 2.0 * g, min=0.0)


def _best_two(dist2: torch.Tensor):
    """Per-row (best_idx, best, second) without a full sort; argmin
    returns the first minimum, as the reference's does."""
    best = torch.amin(dist2, dim=-1)
    idx = torch.argmin(dist2, dim=-1)
    masked = dist2.scatter(-1, idx[..., None], BIG)
    second = torch.amin(masked, dim=-1)
    return idx, best, second


def match_descriptors(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    ratio: float = 1.5,
    mutual: bool = False,
    pair_mask: torch.Tensor | None = None,
) -> Matches:
    """Plain matcher. ``ratio`` follows siftmatch.c semantics: accept when
    best_dist2 * ratio < second_dist2 (ratio > 1).

    pair_mask [N1, N2]: optional per-pair candidate restriction applied
    before the best/second reduction."""
    dist2 = _pairwise_dist2(d1, d2)
    if valid2 is not None:
        dist2 = torch.where(valid2[None, :], dist2, BIG)
    if pair_mask is not None:
        dist2 = torch.where(pair_mask, dist2, BIG)
    idx, best, second = _best_two(dist2)
    accepted = (best * ratio < second) & (best < BIG)
    if valid1 is not None:
        accepted = accepted & valid1
    if mutual:
        # column-wise best must point back at this row
        col_d = dist2 if valid1 is None else torch.where(
            valid1[:, None], dist2, BIG)
        back = torch.argmin(col_d, dim=0)
        rows = torch.arange(d1.shape[0], device=d1.device)
        accepted = accepted & (back[idx] == rows)
    return Matches(index=idx, dist2=best, dist2_second=second,
                   accepted=accepted)


def match_descriptors_auto(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    ratio: float = 1.5,
    pair_mask: torch.Tensor | None = None,
) -> Matches:
    """Production matcher. Where the reference would route to its
    streaming kernel K2 (no pair_mask, n1·n2 ≥ 2048²) a CUDA tensor
    raises, since K2 is not ported yet; everything else takes the plain
    path, as the reference does off the TPU."""
    n1, n2 = d1.shape[0], d2.shape[0]
    if pair_mask is None and d1.is_cuda and n1 * n2 >= _K2_MIN_ELEMS:
        raise NotImplementedError(
            f"match_descriptors_auto: {n1}x{n2} is above the cutover of the "
            "streaming matcher kernel K2 (pre3_tpu/ops/matching.py::"
            "_match_kernel), which is not ported to CUDA yet"
        )
    return match_descriptors(d1, d2, valid1=valid1, valid2=valid2,
                             ratio=ratio, pair_mask=pair_mask)
