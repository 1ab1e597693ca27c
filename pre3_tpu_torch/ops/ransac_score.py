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

The wrapper goes through the custom op ``pre3_tpu_torch::score_hypotheses``,
so ``torch.func.vmap`` can reach the kernel: the op's vmap rule moves the
batch axis to the front, expands the unbatched arguments and calls the
op again with that leading sequence axis, ONE launch of K1 on the card
(on the CPU, the plain version per sequence). The op takes one sequence
axis at most, so nested vmap raises.
"""

from __future__ import annotations

import ctypes

import torch

from pre3_tpu_torch.utils.cuda_build import load_library
from pre3_tpu_torch.utils.launch_count import Counted
from pre3_tpu_torch.utils.vmap_ops import check_not_batched, to_front


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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        floor = lib.ransac_score_floor_launch
        floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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


def _launch(r, t, p1, p2, valid, threshold):
    """K1 on CUDA tensors: one problem (r [B, 3, 3] ...) or, with a
    leading sequence axis on every argument (r [S, B, 3, 3], threshold
    [S]), S problems in one batched launch. Raises on what the kernel
    does not take, on a vmapped tensor, and on a failed launch."""
    check_not_batched("score_hypotheses", r, t, p1, p2, valid, threshold)
    device = r.device
    if device.type != "cuda":
        raise ValueError(f"score_hypotheses: no kernel for device {device}")
    lead = tuple(r.shape[:-3])  # () or (S,)
    if len(lead) > 1:
        raise ValueError(f"score_hypotheses: r must be [B, 3, 3] or "
                         f"[S, B, 3, 3]; got {tuple(r.shape)}")
    b, n = r.shape[-3], p1.shape[-2]
    _check("r", r, torch.float32, (*lead, b, 3, 3), device)
    _check("t", t, torch.float32, (*lead, b, 3), device)
    _check("p1", p1, torch.float32, (*lead, n, 3), device)
    _check("p2", p2, torch.float32, (*lead, n, 3), device)
    _check("valid", valid, torch.bool, (*lead, n), device)
    _check("threshold", threshold, torch.float32, lead, device)
    support = torch.empty((*lead, b), dtype=torch.int32, device=device)
    err = torch.empty((*lead, b), dtype=torch.float32, device=device)
    if b == 0 or 0 in lead:
        return support, err
    lib = _lib()
    ptrs = (r.data_ptr(), t.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            valid.data_ptr(), threshold.data_ptr())
    outs = (support.data_ptr(), err.data_ptr())
    count = score_hypotheses.pointer(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ransac_score_launch(*ptrs, lead[0] if lead else 1, b, n,
                                     *outs, stream, count)
    if rc != 0:
        raise RuntimeError(f"ransac_score kernel launch failed: cudaError {rc} "
                           f"(S={lead[0] if lead else 1}, B={b}, N={n})")
    return support, err


def _run(r, t, p1, p2, valid, threshold):
    """What the custom op computes: K1 on the card, one launch for one
    problem (r [B, 3, 3]) or for a leading sequence axis (r [S, B, 3, 3]);
    on the CPU the plain version, per sequence for a sequence axis. A
    second leading axis (nested vmap) raises."""
    if r.dim() > 4:
        raise RuntimeError(
            f"score_hypotheses: nested vmap is not supported; the kernel "
            f"takes one sequence axis (r {tuple(r.shape)})")
    if r.device.type != "cpu":
        return _launch(r, t, p1, p2, valid, threshold)
    if r.dim() == 3:
        return score_hypotheses_torch(r, t, p1, p2, valid, threshold)
    rows = [score_hypotheses_torch(*xs)
            for xs in zip(r, t, p1, p2, valid, threshold)]
    return tuple(torch.stack(col) for col in zip(*rows))


@torch.library.custom_op(
    "pre3_tpu_torch::score_hypotheses", mutates_args=(),
    schema="(Tensor r, Tensor t, Tensor p1, Tensor p2, Tensor valid, "
           "Tensor threshold) -> (Tensor, Tensor)")
def _score_op(r, t, p1, p2, valid, threshold):
    return _run(r, t, p1, p2, valid, threshold)


@_score_op.register_fake
def _fake(r, t, p1, p2, valid, threshold):
    shape = r.shape[:-2]
    return (r.new_empty(shape, dtype=torch.int32),
            r.new_empty(shape, dtype=torch.float32))


@_score_op.register_vmap
def _score_vmap(info, in_dims, *args):
    return _score_op(*to_front(info.batch_size, in_dims, args)), (0, 0)


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
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"score_hypotheses: no kernel for device {r.device}")
    return _score_op(r, t, p1, p2, valid, threshold)
