"""Descriptor matching: squared distances + Lowe ratio test (kernel K2).

Port of ``pre3_tpu/ops/matching.py``. Per row of d1, the best column of
d2 by squared L2 distance (|a|² + |b|² − 2a·b, clamped at 0), the two
smallest distances, and the ratio test (accept when best·ratio < second).

  match_descriptors    — the plain PyTorch version: the [N1, N2] distance
                         matrix as one matmul, then a best/second
                         reduction. The CPU path, the only path with a
                         ``pair_mask`` or ``mutual``, and K2's oracle.
  match_descriptors_k2 — the wrapper of K2, the streaming best/second
                         matcher ``csrc/match_stream.cu``: CUDA tensors
                         launch it or raise, CPU tensors take the plain
                         version.
  match_descriptors_auto — the production matcher: K2's wrapper for every
                         unmasked match, the plain version with a
                         ``pair_mask``.

CUDA tensors go through the custom op ``pre3_tpu_torch::match_stream``,
whose vmap rule makes one launch of K2 for S sequences, a shared d2
expanded (``ops/kernel_op.py``, which K1–K4 share).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pre3_tpu_torch.ops.kernel_op import HandKernel
from pre3_tpu_torch.utils.launch_count import Counted

BIG = 1e30
K2_MAX_DIM = 256  # widest rows K2 stages in shared memory (kMaxD)
K2_RANKS = 8  # blocks per cluster in K2, each a range of d2's columns


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


def _ratio_test(best, second, ratio, valid1):
    accepted = (best * ratio < second) & (best < BIG)
    if valid1 is not None:
        accepted = accepted & valid1
    return accepted


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
    accepted = _ratio_test(best, second, ratio, valid1)
    if mutual:
        # column-wise best must point back at this row
        col_d = dist2 if valid1 is None else torch.where(
            valid1[:, None], dist2, BIG)
        back = torch.argmin(col_d, dim=0)
        rows = torch.arange(d1.shape[0], device=d1.device)
        accepted = accepted & (back[idx] == rows)
    return Matches(index=idx, dist2=best, dist2_second=second,
                   accepted=accepted)


K2 = HandKernel("match_stream", "match_descriptors_k2", arg="d1",
                shape="N1, D", inputs=3, scalars=[ctypes.c_int] * 3,
                outputs=3, floor=[ctypes.c_int] * 4 + [ctypes.c_void_p])


def _k2_sizes(d1: torch.Tensor, d2: torch.Tensor):
    """(N1, N2, D) of what K2 takes, with or without a leading sequence
    axis; raises on any other shape."""
    if d1.dim() not in (2, 3) or d2.dim() != d1.dim() or (
        d1.shape[:-2] != d2.shape[:-2] or d1.shape[-1] != d2.shape[-1]
    ):
        raise ValueError(
            "match_descriptors_k2 takes d1 [N1, D] and d2 [N2, D] (or both "
            f"with a leading sequence axis); got {tuple(d1.shape)} and "
            f"{tuple(d2.shape)}")
    (n1, d), n2 = d1.shape[-2:], d2.shape[-2]
    if n2 < 1 or not 1 <= d <= K2_MAX_DIM:
        raise ValueError(f"match_descriptors_k2: needs N2 ≥ 1 and 1 ≤ D ≤ "
                         f"{K2_MAX_DIM}; got N2={n2}, D={d}")
    return n1, n2, d


def _launch_k2(d1: torch.Tensor, d2: torch.Tensor,
               valid2: torch.Tensor | None):
    """K2 alone on CUDA tensors: (index, best, second) per row of d1
    [N1, D] against d2 [N2, D], or, with a leading sequence axis on every
    argument (d1 [S, N1, D], d2 [S, N2, D], valid2 [S, N2]), S problems
    in one batched launch. Raises on what the kernel does not take, on a
    vmapped tensor, and on a failed launch."""
    lead = K2.lead(d1, d2, valid2)
    (n1, n2, d), device = _k2_sizes(d1, d2), d1.device
    K2.check("d1", d1, torch.float32, (*lead, n1, d), device)
    K2.check("d2", d2, torch.float32, (*lead, n2, d), device)
    if valid2 is not None:
        K2.check("valid2", valid2, torch.bool, (*lead, n2), device)
    idx = torch.empty((*lead, n1), dtype=torch.int64, device=device)
    best = torch.empty((*lead, n1), dtype=torch.float32, device=device)
    second = torch.empty((*lead, n1), dtype=torch.float32, device=device)
    K2.launch(match_descriptors_k2, lead, (d1, d2, valid2),
              (idx, best, second), dict(N1=n1, N2=n2, D=d))
    return idx, best, second


def _plain_k2(d1, d2, valid2):
    m = match_descriptors(d1, d2, valid2=valid2)
    return m.index, m.dist2, m.dist2_second


def _k2_fake(d1, d2, valid2):
    shape = d1.shape[:-1]
    return (d1.new_empty(shape, dtype=torch.int64), d1.new_empty(shape),
            d1.new_empty(shape))


K2.define("pre3_tpu_torch::match_stream",
          "(Tensor d1, Tensor d2, Tensor? valid2) -> (Tensor, Tensor, Tensor)",
          _launch_k2, _plain_k2, _k2_fake)


@Counted
def match_descriptors_k2(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    ratio: float = 1.5,
) -> Matches:
    """Streaming matcher: kernel K2 for CUDA tensors, the plain version
    for CPU tensors; under ``torch.func.vmap`` one batched launch for all
    sequences. Nothing falls back: a CUDA input the kernel does not take
    raises. The ratio test and ``valid1`` are applied after the kernel,
    as the reference does.

    ``match_descriptors_k2.launches`` counts the kernel's runs, added on
    the device by the kernel itself (a batched launch counts one, and so
    does each replay of a graph that holds one; ``utils/launch_count``)."""
    if d1.device.type != "cpu":
        _k2_sizes(d1, d2)  # shape errors first, before any device work
    if K2.on_cpu(d1):
        return match_descriptors(d1, d2, valid1=valid1, valid2=valid2,
                                 ratio=ratio)
    idx, best, second = K2.op(d1, d2, valid2)
    return Matches(index=idx, dist2=best, dist2_second=second,
                   accepted=_ratio_test(best, second, ratio, valid1))


def match_descriptors_auto(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    ratio: float = 1.5,
    pair_mask: torch.Tensor | None = None,
) -> Matches:
    """Production matcher. Every unmasked match goes to K2's wrapper, at
    any size: on the H100 the plain path is a dozen small launches where
    K2 is one, and the port's per-frame loop is bound by launches (the
    reference's TPU cutover at 2048² does not carry over). A
    ``pair_mask`` takes the plain path: K2 keeps no [N1, N2] tile to mask.
    """
    if pair_mask is None:
        return match_descriptors_k2(d1, d2, valid1=valid1, valid2=valid2,
                                    ratio=ratio)
    return match_descriptors(d1, d2, valid1=valid1, valid2=valid2,
                             ratio=ratio, pair_mask=pair_mask)
