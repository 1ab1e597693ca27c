"""Trajectory smoothing: propagate keyframe BA corrections to all frames.

Port of ``pre3_tpu/backend/smoothing.py``. The correction of keyframe k,
ΔT_k = T_ba(k) ∘ T_est(k)⁻¹, is interpolated between consecutive
keyframes (linear in translation, slerp in rotation) and applied to every
frame.
"""

from __future__ import annotations

import torch

from pre3_tpu_torch.geometry.quaternion import qconj, qnormalize, qprod, qrotate


def slerp(q0: torch.Tensor, q1: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Quaternion slerp, batched over leading axes; nlerp for near-equal
    rotations."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    small = sin_t < 1e-5
    safe = torch.where(small, 1.0, sin_t)
    w0 = torch.where(small, 1.0 - u, torch.sin((1.0 - u) * theta) / safe)
    w1 = torch.where(small, u, torch.sin(u * theta) / safe)
    return qnormalize(w0 * q0 + w1 * q1)


def apply_ba_corrections(
    traj_t: torch.Tensor,  # [F, 3] original per-frame positions
    traj_q: torch.Tensor,  # [F, 4]
    kf_indices: torch.Tensor,  # [M] keyframe frame indices (sorted)
    kf_valid: torch.Tensor,  # [M] bool
    ba_t: torch.Tensor,  # [M, 3] refined keyframe positions
    ba_q: torch.Tensor,  # [M, 4]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Smoothed full trajectory (t, q)."""
    n = traj_t.shape[0]
    dev = traj_t.device
    kf_indices = kf_indices.to(torch.int64)
    # per-keyframe left corrections ΔT = T_ba ∘ T_est⁻¹
    dt_q = qnormalize(qprod(ba_q, qconj(traj_q[kf_indices])))
    dt_t = ba_t - qrotate(dt_q, traj_t[kf_indices])

    # surrounding keyframes of each frame (searchsorted on the valid
    # prefix) and the interpolation fraction
    n_valid = torch.sum(kf_valid).to(torch.int64)
    idxs = torch.where(kf_valid, kf_indices, n + 1)  # invalid → past the end
    frames = torch.arange(n, device=dev)
    hi = torch.searchsorted(idxs, frames, right=True)
    hi = torch.minimum(torch.clamp(hi, min=1), n_valid - 1)
    lo = hi - 1
    f_lo, f_hi = idxs[lo], idxs[hi]
    u = torch.clamp((frames - f_lo).to(torch.float32)
                    / torch.clamp(f_hi - f_lo, min=1).to(torch.float32),
                    0.0, 1.0).to(traj_t.dtype)

    q_corr = slerp(dt_q[lo], dt_q[hi], u[:, None])
    t_corr = (1.0 - u)[:, None] * dt_t[lo] + u[:, None] * dt_t[hi]
    new_q = qnormalize(qprod(q_corr, traj_q))
    new_t = qrotate(q_corr, traj_t) + t_corr
    return new_t, new_q
