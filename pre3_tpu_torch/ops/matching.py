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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pre3_tpu_torch.utils.cuda_build import load_library

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


def _lib() -> ctypes.CDLL:
    lib = load_library("match_stream")
    fn = lib.match_stream_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        floor = lib.match_stream_floor_launch
        floor.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        floor.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device or (
        not x.is_contiguous()
    ):
        raise ValueError(
            f"match_descriptors_k2: {name} must be a contiguous {dtype} "
            f"tensor of shape {shape} on {device}; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}, contiguous={x.is_contiguous()}"
        )


def _launch_k2(d1: torch.Tensor, d2: torch.Tensor,
               valid2: torch.Tensor | None):
    """K2 alone on CUDA tensors: (index, best, second) per row of d1.
    Raises on what the kernel does not take, and on a failed launch."""
    if d1.dim() != 2 or d2.dim() != 2 or d1.shape[1] != d2.shape[1]:
        raise ValueError(
            "match_descriptors_k2 takes d1 [N1, D] and d2 [N2, D]; got "
            f"{tuple(d1.shape)} and {tuple(d2.shape)}")
    (n1, d), n2 = d1.shape, d2.shape[0]
    if n2 < 1 or not 1 <= d <= K2_MAX_DIM:
        raise ValueError(f"match_descriptors_k2: needs N2 ≥ 1 and 1 ≤ D ≤ "
                         f"{K2_MAX_DIM}; got N2={n2}, D={d}")
    device = d1.device
    if device.type != "cuda":
        raise ValueError(f"match_descriptors_k2: no kernel for device {device}")
    _check("d1", d1, torch.float32, (n1, d), device)
    _check("d2", d2, torch.float32, (n2, d), device)
    if valid2 is not None:
        _check("valid2", valid2, torch.bool, (n2,), device)
    idx = torch.empty(n1, dtype=torch.int64, device=device)
    best = torch.empty(n1, dtype=torch.float32, device=device)
    second = torch.empty(n1, dtype=torch.float32, device=device)
    if n1:
        lib = _lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.match_stream_launch(
                d1.data_ptr(), d2.data_ptr(),
                0 if valid2 is None else valid2.data_ptr(), n1, n2, d,
                idx.data_ptr(), best.data_ptr(), second.data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"match_stream kernel launch failed: cudaError "
                               f"{rc} (N1={n1}, N2={n2}, D={d})")
        match_descriptors_k2.launches += 1
    return idx, best, second


def match_descriptors_k2(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    ratio: float = 1.5,
) -> Matches:
    """Streaming matcher: kernel K2 for CUDA tensors, the plain version
    for CPU tensors. Nothing falls back: a CUDA input the kernel does not
    take raises. The ratio test and ``valid1`` are applied after the
    kernel, as the reference does.

    ``match_descriptors_k2.launches`` counts kernel launches."""
    if d1.device.type == "cpu":
        return match_descriptors(d1, d2, valid1=valid1, valid2=valid2,
                                 ratio=ratio)
    idx, best, second = _launch_k2(d1, d2, valid2)
    return Matches(index=idx, dist2=best, dist2_second=second,
                   accepted=_ratio_test(best, second, ratio, valid1))


match_descriptors_k2.launches = 0


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
