"""Batched RANSAC hypothesis support scoring (kernel K1).

Port of ``pre3_tpu/ops/ransac_score.py``: for every hypothesis (R_b, t_b)
and every matched point pair, ‖R_b·p2 + t_b − p1‖², reduced to
per-hypothesis support counts and mean inlier errors.

  score_hypotheses_torch — the plain PyTorch version (the reference's
                           ``score_hypotheses_xla``); the CPU path and the
                           kernel's oracle.
  score_hypotheses       — the wrapper: CPU tensors go to the plain
                           version, CUDA tensors launch the hand-written
                           kernel ``csrc/ransac_score.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from pre3_tpu_torch.utils.cuda_build import load_library


def residuals_torch(
    r: torch.Tensor,  # [B, 3, 3]
    t: torch.Tensor,  # [B, 3]
    p1: torch.Tensor,  # [N, 3]
    p2: torch.Tensor,  # [N, 3]
) -> torch.Tensor:
    """[B, N] squared residuals ‖R_b·p2_n + t_b − p1_n‖².

    Written out as separate products and sums, in the order the CUDA
    kernel rounds them (``__fmul_rn``/``__fadd_rn``, no fused
    multiply-add), so kernel and plain version compute bitwise-equal
    residuals and may differ only in the order of the error sum."""

    def diff(i: int) -> torch.Tensor:  # [B, N] component i of pred − p1
        pred = (r[:, i, 0, None] * p2[:, 0] + r[:, i, 1, None] * p2[:, 1]
                + r[:, i, 2, None] * p2[:, 2] + t[:, i, None])
        return pred - p1[:, i]

    dx, dy, dz = diff(0), diff(1), diff(2)
    return dx * dx + dy * dy + dz * dz


def score_hypotheses_torch(
    r: torch.Tensor,  # [B, 3, 3]
    t: torch.Tensor,  # [B, 3]
    p1: torch.Tensor,  # [N, 3]
    p2: torch.Tensor,  # [N, 3]
    valid: torch.Tensor,  # [N] bool
    threshold: torch.Tensor,  # [] squared-distance gate
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (support [B] int32, mean_err [B] float32)."""
    resid2 = residuals_torch(r, t, p1, p2)
    inlier = (resid2 < threshold) & valid[None]
    support = torch.sum(inlier, dim=-1, dtype=torch.int32)
    err = torch.sum(torch.where(inlier, resid2, 0.0), dim=-1) / torch.clamp(
        support, min=1
    )
    return support, err


def _lib() -> ctypes.CDLL:
    lib = load_library("ransac_score")
    fn = lib.ransac_score_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        floor = lib.ransac_score_floor_launch
        floor.argtypes = [ctypes.c_int, ctypes.c_void_p]
        floor.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device or (
        not x.is_contiguous()
    ):
        raise ValueError(
            f"score_hypotheses: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}, contiguous={x.is_contiguous()}"
        )


def score_hypotheses(
    r: torch.Tensor,
    t: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    threshold: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Production scorer (used by vo/ransac.py): the CUDA kernel K1 for
    CUDA tensors, the plain version for CPU tensors. Nothing falls back:
    a CUDA input the kernel does not take raises.

    ``score_hypotheses.launches`` counts kernel launches."""
    device = r.device
    if device.type == "cpu":
        return score_hypotheses_torch(r, t, p1, p2, valid, threshold)
    if device.type != "cuda":
        raise ValueError(f"score_hypotheses: no kernel for device {device}")
    b, n = r.shape[0], p1.shape[0]
    _check("r", r, torch.float32, (b, 3, 3), device)
    _check("t", t, torch.float32, (b, 3), device)
    _check("p1", p1, torch.float32, (n, 3), device)
    _check("p2", p2, torch.float32, (n, 3), device)
    _check("valid", valid, torch.bool, (n,), device)
    _check("threshold", threshold, torch.float32, (), device)
    support = torch.empty(b, dtype=torch.int32, device=device)
    err = torch.empty(b, dtype=torch.float32, device=device)
    if b == 0:
        return support, err
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ransac_score_launch(
            r.data_ptr(), t.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            valid.data_ptr(), threshold.data_ptr(), b, n,
            support.data_ptr(), err.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ransac_score kernel launch failed: cudaError {rc} (B={b}, N={n})"
        )
    score_hypotheses.launches += 1
    return support, err


score_hypotheses.launches = 0
