"""Patch descriptors: zero-mean, unit-norm intensity patches at keypoints.

Port of ``pre3_tpu/frontend/patches.py``. With such descriptors, squared
L2 distance is NCC: ‖a − b‖² = 2(1 − NCC(a, b)). The reference samples the
patch grid with two blend matmuls, a TPU layout choice; here it is the
4-corner bilinear gather, which gives the same values (to ~1e-7).
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample img [..., H, W] at float pixel positions uv [..., M, 2]
    (u=col, v=row) with bilinear interpolation and edge clamping.

    The leading axes of ``img`` and ``uv`` are the same frame axes; M
    may itself be several axes, flattened for the gather."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    pts = uv.shape[len(lead):-1]
    uv = uv.reshape(*lead, -1, 2)
    flat = img.reshape(*lead, h * w)
    u = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    du = u - u0f
    dv = v - v0f
    base = v0f.to(torch.int64) * w + u0f.to(torch.int64)

    def at(offset: int) -> torch.Tensor:
        return torch.gather(flat, -1, base + offset)

    out = (
        at(0) * (1 - du) * (1 - dv)
        + at(1) * du * (1 - dv)
        + at(w) * (1 - du) * dv
        + at(w + 1) * du * dv
    )
    return out.reshape(*lead, *pts)


def extract_patch_descriptors(
    img: torch.Tensor,  # [..., H, W]
    uv: torch.Tensor,  # [..., K, 2] keypoint centers
    patch: int = 11,
    stride: float = 1.0,
) -> torch.Tensor:
    """[..., K, patch²] zero-mean unit-norm patch descriptors, row-major
    (v, u) grid order. Matching them by squared L2 distance is NCC
    matching: the 0.60 correlation gate becomes dist² < 0.80."""
    half = (patch - 1) / 2.0
    offs = (torch.arange(patch, dtype=img.dtype, device=img.device)
            - half) * stride
    gu = uv[..., 0][..., None, None] + offs[None, :]  # [..., K, 1, P]
    gv = uv[..., 1][..., None, None] + offs[:, None]  # [..., K, P, 1]
    gu, gv = torch.broadcast_tensors(gu, gv)  # [..., K, P, P]
    vals = bilinear_sample(img, torch.stack([gu, gv], dim=-1))
    vals = vals.flatten(-2)
    vals = vals - torch.mean(vals, dim=-1, keepdim=True)
    n = torch.linalg.vector_norm(vals, dim=-1, keepdim=True)
    return vals / torch.clamp(n, min=1e-8)


def ncc_from_dist2(dist2: torch.Tensor) -> torch.Tensor:
    """Convert matcher squared distances back to NCC values."""
    return 1.0 - 0.5 * dist2
