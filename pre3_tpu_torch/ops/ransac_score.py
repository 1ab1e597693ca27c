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

CUDA tensors go through the custom op ``pre3_tpu_torch::score_hypotheses``,
whose vmap rule makes one launch of K1 for S sequences
(``ops/kernel_op.py``, which K1–K4 share).
"""

from __future__ import annotations

import ctypes

import torch

from pre3_tpu_torch.ops.kernel_op import HandKernel
from pre3_tpu_torch.utils.launch_count import Counted


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


K1 = HandKernel("ransac_score", "score_hypotheses", arg="r",
                shape="B, 3, 3", inputs=6, scalars=[ctypes.c_int] * 2,
                outputs=2, floor=[ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])


def _launch(r, t, p1, p2, valid, threshold):
    """K1 on CUDA tensors: one problem (r [B, 3, 3] ...) or, with a
    leading sequence axis on every argument (r [S, B, 3, 3], threshold
    [S]), S problems in one batched launch. Raises on what the kernel
    does not take, on a vmapped tensor, and on a failed launch."""
    lead = K1.lead(r, t, p1, p2, valid, threshold)
    device, b, n = r.device, r.shape[-3], p1.shape[-2]
    K1.check("r", r, torch.float32, (*lead, b, 3, 3), device)
    K1.check("t", t, torch.float32, (*lead, b, 3), device)
    K1.check("p1", p1, torch.float32, (*lead, n, 3), device)
    K1.check("p2", p2, torch.float32, (*lead, n, 3), device)
    K1.check("valid", valid, torch.bool, (*lead, n), device)
    K1.check("threshold", threshold, torch.float32, lead, device)
    support = torch.empty((*lead, b), dtype=torch.int32, device=device)
    err = torch.empty((*lead, b), dtype=torch.float32, device=device)
    K1.launch(score_hypotheses, lead, (r, t, p1, p2, valid, threshold),
              (support, err), dict(B=b, N=n))
    return support, err


def _fake(r, t, p1, p2, valid, threshold):
    shape = r.shape[:-2]
    return (r.new_empty(shape, dtype=torch.int32),
            r.new_empty(shape, dtype=torch.float32))


K1.define("pre3_tpu_torch::score_hypotheses",
          "(Tensor r, Tensor t, Tensor p1, Tensor p2, Tensor valid, "
          "Tensor threshold) -> (Tensor, Tensor)",
          _launch, score_hypotheses_torch, _fake)


@Counted
def score_hypotheses(
    r: torch.Tensor,
    t: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    threshold: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Production scorer (used by vo/ransac.py): the CUDA kernel K1 for
    CUDA tensors, the plain version for CPU tensors; under
    ``torch.func.vmap`` one batched launch for all sequences. Nothing
    falls back: a CUDA input the kernel does not take raises.

    ``score_hypotheses.launches`` counts the kernel's runs, added on the
    device by the kernel itself (a batched launch counts one, and so
    does each replay of a graph that holds one; ``utils/launch_count``)."""
    if K1.on_cpu(r):
        return score_hypotheses_torch(r, t, p1, p2, valid, threshold)
    return K1.op(r, t, p1, p2, valid, threshold)
