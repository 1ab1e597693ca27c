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

K2's wrapper goes through the custom op ``pre3_tpu_torch::match_stream``,
so ``torch.func.vmap`` can reach the kernel: the op's vmap rule moves the
batch axis to the front, expands the unbatched arguments (a shared d2,
say) and calls the op again with that leading sequence axis, ONE launch
of K2 on the card (on the CPU, the plain version per sequence). The op
takes one sequence axis at most, so nested vmap raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pre3_tpu_torch.utils.cuda_build import load_library
from pre3_tpu_torch.utils.launch_count import Counted
from pre3_tpu_torch.utils.vmap_ops import check_not_batched, to_front

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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        floor = lib.match_stream_floor_launch
        floor.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
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


def _k2_sizes(d1: torch.Tensor, d2: torch.Tensor):
    """(lead, N1, N2, D) of what K2 takes, lead () or (S,); raises on
    any other shape."""
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
    return tuple(d1.shape[:-2]), n1, n2, d


def _launch_k2(d1: torch.Tensor, d2: torch.Tensor,
               valid2: torch.Tensor | None):
    """K2 alone on CUDA tensors: (index, best, second) per row of d1
    [N1, D] against d2 [N2, D], or, with a leading sequence axis on every
    argument (d1 [S, N1, D], d2 [S, N2, D], valid2 [S, N2]), S problems
    in one batched launch. Raises on what the kernel does not take, on a
    vmapped tensor, and on a failed launch."""
    check_not_batched("match_descriptors_k2", d1, d2, valid2)
    lead, n1, n2, d = _k2_sizes(d1, d2)
    device = d1.device
    if device.type != "cuda":
        raise ValueError(f"match_descriptors_k2: no kernel for device {device}")
    _check("d1", d1, torch.float32, (*lead, n1, d), device)
    _check("d2", d2, torch.float32, (*lead, n2, d), device)
    if valid2 is not None:
        _check("valid2", valid2, torch.bool, (*lead, n2), device)
    idx = torch.empty((*lead, n1), dtype=torch.int64, device=device)
    best = torch.empty((*lead, n1), dtype=torch.float32, device=device)
    second = torch.empty((*lead, n1), dtype=torch.float32, device=device)
    if n1 and 0 not in lead:
        lib = _lib()
        ptrs = (d1.data_ptr(), d2.data_ptr(),
                0 if valid2 is None else valid2.data_ptr())
        outs = (idx.data_ptr(), best.data_ptr(), second.data_ptr())
        count = match_descriptors_k2.pointer(device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            s = lead[0] if lead else 1
            rc = lib.match_stream_launch(*ptrs, s, n1, n2, d, *outs, stream,
                                         count)
        if rc != 0:
            raise RuntimeError(f"match_stream kernel launch failed: cudaError "
                               f"{rc} (S={s}, N1={n1}, N2={n2}, D={d})")
    return idx, best, second


def _plain_k2(d1, d2, valid2):
    m = match_descriptors(d1, d2, valid2=valid2)
    return m.index, m.dist2, m.dist2_second


def _run_k2(d1, d2, valid2):
    """What the custom op computes: K2 on the card, one launch for one
    problem (d1 [N1, D]) or for a leading sequence axis (d1 [S, N1, D]);
    on the CPU the plain matcher's (index, best, second), per sequence
    for a sequence axis. A second leading axis (nested vmap) raises."""
    if d1.dim() > 3:
        raise RuntimeError(
            f"match_descriptors_k2: nested vmap is not supported; the kernel "
            f"takes one sequence axis (d1 {tuple(d1.shape)})")
    if d1.device.type != "cpu":
        return _launch_k2(d1, d2, valid2)
    if d1.dim() == 2:
        return _plain_k2(d1, d2, valid2)
    v2 = [None] * d1.shape[0] if valid2 is None else valid2
    rows = [_plain_k2(*xs) for xs in zip(d1, d2, v2)]
    return tuple(torch.stack(col) for col in zip(*rows))


@torch.library.custom_op(
    "pre3_tpu_torch::match_stream", mutates_args=(),
    schema="(Tensor d1, Tensor d2, Tensor? valid2) -> (Tensor, Tensor, Tensor)")
def _k2_op(d1, d2, valid2):
    return _run_k2(d1, d2, valid2)


@_k2_op.register_fake
def _k2_fake(d1, d2, valid2):
    shape = d1.shape[:-1]
    return (d1.new_empty(shape, dtype=torch.int64), d1.new_empty(shape),
            d1.new_empty(shape))


@_k2_op.register_vmap
def _k2_vmap(info, in_dims, *args):
    return _k2_op(*to_front(info.batch_size, in_dims, args)), (0, 0, 0)


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
        if d1.device.type != "cuda":
            raise ValueError(f"match_descriptors_k2: no kernel for device "
                             f"{d1.device}")
    idx, best, second = _k2_op(d1, d2, valid2)
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
