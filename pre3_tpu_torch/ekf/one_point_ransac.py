"""1-point / 3-point RANSAC inlier gating inside the EKF.

Port of ``pre3_tpu/ekf/one_point_ransac.py``. All B hypotheses are drawn
at once ([B, S] Gumbel-top-k samples without replacement among the
individually compatible matches), their partial state updates are one
batched gain application (ΔX_b = P H_bᵀ S_b⁻¹ ν_b with the unrolled
batched Cholesky solve), every landmark is reprojected under every
hypothesis as a [B, K] tensor op, and the best support wins. Then the
high-innovation rescue: a χ²(2, 0.95) gate of the remaining matches
against the post-update state.

The Gumbel draws are an input (``gumbel`` [B, M]) or come from a
``generator``; nothing reads a value back to the host.
"""

from __future__ import annotations

import torch

from pre3_tpu_torch.ekf.measurement import (
    Observations, measure_one, predict_measurements,
)
from pre3_tpu_torch.ekf.state import CAM_DIM, LM_DIM, EkfState
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.ops.small_chol import chol_solve_unrolled
from pre3_tpu_torch.utils.topk import stable_topk
from pre3_tpu_torch.vo.ransac import _draw_gumbel

CHI2_2_95 = 5.9915


def pool_size(n_landmarks: int, max_slots: int | None) -> int:
    """Width M of the hypothesis-draw pool (the Gumbel draws' last axis)."""
    return max_slots if max_slots is not None and max_slots < n_landmarks \
        else n_landmarks


def one_point_ransac(
    cam_model: Camera,
    state: EkfState,
    obs: Observations,
    batch: int = 256,
    std_z: float = 1.0,
    n_points: int = 3,
    max_slots: int | None = None,
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Select low-innovation inliers among the IC matches. Returns [K]
    bool.

    n_points: matches stacked per hypothesis. 3 is the reference's 3PRE
    mode (3-match hypotheses when more than 3 IC matches exist, 1-match
    otherwise); 1 forces the classic 1-point variant. The support
    threshold is std_z.

    max_slots: bound the draw pool to the M IC slots gathered first by a
    stable top-k. Support and the returned mask still cover all K slots.

    gumbel [batch, M]: the sampling noise (M = ``pool_size(K,
    max_slots)``); if absent it is drawn from ``generator``.
    """
    k = state.n_landmarks
    ic = obs.ic
    num_ic = torch.sum(ic)
    device = ic.device

    p = state.p
    pc = p[:, :CAM_DIM]  # [D, 13]
    m_pool = pool_size(k, max_slots)
    if m_pool < k:
        _, pool = stable_topk(ic.to(torch.int32), m_pool)  # [M]
        hc_pool = obs.hc[pool]
        hl_pool = obs.hl[pool]
        nu_pool = (obs.z - obs.h)[pool]
        ic_pool = ic[pool]
        pl_pool = p[:, CAM_DIM:].reshape(-1, k, LM_DIM)[:, pool, :]
    else:
        pool = torch.arange(k, device=device)
        hc_pool, hl_pool = obs.hc, obs.hl
        nu_pool = obs.z - obs.h
        ic_pool = ic
        pl_pool = p[:, CAM_DIM:].reshape(-1, k, LM_DIM)

    if gumbel is None:
        if generator is None:
            raise ValueError("one_point_ransac needs gumbel noise or a "
                             "generator")
        gumbel = _draw_gumbel((batch, m_pool), generator, device=device)
    if tuple(gumbel.shape) != (batch, m_pool):
        raise ValueError(f"gumbel must have shape {(batch, m_pool)}, got "
                         f"{tuple(gumbel.shape)}")

    # [B, S] hypothesis draws INTO THE POOL without replacement within a
    # hypothesis, ∝ the IC mask; ties among the -inf logits of non-IC
    # slots resolve to the lower index, as jax.lax.top_k does.
    logits = torch.where(ic_pool, 0.0, -torch.inf)
    _, idx = stable_topk(logits[None] + gumbel, n_points)  # [B, S]
    # 3-match hypotheses only when more than S IC matches exist, else
    # 1-match; surplus draws are masked to exact no-ops.
    n_use = torch.where(num_ic > n_points, n_points, 1)
    use = (torch.arange(n_points, device=device)[None, :] < n_use) & (
        ic_pool[idx])  # [B, S]

    # Zero the non-IC JACOBIAN rows first: inactive slots carry NaN
    # Jacobians and the ΔX contraction multiplies every pool row by its
    # (possibly zero) gain, so 0·NaN would poison the whole batch.
    hc_pool = torch.where(ic_pool[:, None, None], hc_pool, 0.0)
    hl_pool = torch.where(ic_pool[:, None, None], hl_pool, 0.0)
    # per-landmark gain column blocks P H_iᵀ for the pool: [M, D, 2]
    ph = torch.einsum("dc,kec->kde", pc, hc_pool) + torch.einsum(
        "dkl,kel->kde", pl_pool, hl_pool)
    ph_cam = ph[:, :CAM_DIM, :]  # [M, 13, 2]

    # Per-hypothesis gain y = S⁻¹ν [2S] from its stacked matches, batched
    # over B. S[2j:2j+2, 2m:2m+2] = H_j (P H_mᵀ); H_j touches only the
    # camera block and landmark block j.
    u4 = use[..., None, None]
    hc = torch.where(u4, hc_pool[idx], 0.0)  # [B, S, 2, 13]
    hl = torch.where(u4, hl_pool[idx], 0.0)  # [B, S, 2, 6]
    nu = torch.where(use[..., None], nu_pool[idx], 0.0)  # [B, S, 2]
    phs_cam = torch.where(u4, ph_cam[idx], 0.0)  # [B, S, 13, 2]
    s_cam = torch.einsum("bjac,bmce->bjame", hc, phs_cam)
    rows = (CAM_DIM + pool[idx][..., None] * LM_DIM
            + torch.arange(LM_DIM, device=device))  # [B, S(j), 6]
    # lm_rows[b, j, m, l, e] = ph[idx[b, m], rows[b, j, l], e]
    lm_rows = ph[idx[:, None, :, None], rows[:, :, None, :], :]
    lm_rows = torch.where(use[:, None, :, None, None], lm_rows, 0.0)
    s_lm = torch.einsum("bjal,bjmle->bjame", hl, lm_rows)
    s_pts = n_points
    s = (s_cam + s_lm).reshape(batch, 2 * s_pts, 2 * s_pts)
    s = s + (std_z**2) * torch.eye(2 * s_pts, dtype=s.dtype, device=device)
    ys = chol_solve_unrolled(s, nu.reshape(batch, 2 * s_pts))  # [B, 2S]

    # ΔX_b = Σ_s ph[idx[b,s]] · y_b[2s:2s+2]: route the gains into pool
    # space (one-hot contraction) and contract once, [B, M, 2] × [M, D, 2].
    ys_gated = torch.where(use[..., None], ys.reshape(batch, s_pts, 2), 0.0)
    onehot = (idx[..., None] == torch.arange(m_pool, device=device)).to(
        ph.dtype)
    w = torch.einsum("bsm,bse->bme", onehot, ys_gated)  # [B, M, 2]
    dx = torch.einsum("bme,mde->bd", w, ph)  # [B, D]
    x_hyp = state.x[None] + dx  # [B, D]

    # Support: reproject every landmark under every hypothesis state.
    h_all = measure_one(cam_model, x_hyp[:, None, :CAM_DIM],
                        x_hyp[:, CAM_DIM:].reshape(batch, k, LM_DIM),
                        state.is_id[None, :])  # [B, K, 2]
    resid = torch.linalg.vector_norm(obs.z[None] - h_all, dim=-1)  # [B, K]
    inlier = (resid < std_z) & ic[None]
    support = torch.sum(inlier, dim=-1)  # [B]
    # a hypothesis from an invalid draw (no IC at all) has support 0
    best = torch.argmax(support).reshape(1)  # first maximum, on device
    return torch.index_select(inlier, 0, best)[0] & torch.any(ic)


def rescue_hi_inliers(
    cam_model: Camera,
    state: EkfState,  # post low-innovation update
    obs: Observations,
    li: torch.Tensor,
    std_z: float = 1.0,
) -> tuple[torch.Tensor, Observations]:
    """χ² gate the remaining IC matches against the post-li state (h/H
    recomputed there, then νᵀS⁻¹ν < χ²(2, 0.95)). Returns (hi mask [K],
    refreshed Observations carrying the recomputed h/H/S)."""
    obs2 = predict_measurements(cam_model, state, std_z=std_z)
    obs2 = obs2._replace(z=obs.z, ic=obs.ic)
    nu = obs.z - obs2.h  # [K, 2]
    # closed-form batched 2×2 inverse for the χ² forms
    s00 = obs2.s[:, 0, 0]
    s01 = obs2.s[:, 0, 1]
    s10 = obs2.s[:, 1, 0]
    s11 = obs2.s[:, 1, 1]
    det = s00 * s11 - s01 * s10
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    chi2 = inv_det * (s11 * nu[:, 0] ** 2
                      - (s01 + s10) * nu[:, 0] * nu[:, 1]
                      + s00 * nu[:, 1] ** 2)
    hi = obs.ic & (~li) & (chi2 < CHI2_2_95)
    return hi, obs2
