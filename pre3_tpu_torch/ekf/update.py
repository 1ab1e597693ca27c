"""EKF update: masked batch Kalman update + quaternion renorm.

Port of ``kalman_update`` and ``renormalize_quaternion`` of
``pre3_tpu/ekf/update.py``. Excluded measurements are zero-padded: zero H
rows and zero innovation with unit R make a measurement an exact no-op,
so the [2K, D] system has a static shape. The reference's
``heading_update``, ``attitude_update`` and ``iterated_kalman_update`` are
not on the ported path (ekf/slam.py raises for their options).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from pre3_tpu_torch.ekf.measurement import Observations
from pre3_tpu_torch.ekf.state import CAM_DIM, LM_DIM, EkfState
from pre3_tpu_torch.geometry.quaternion import qnormalize
from pre3_tpu_torch.utils.topk import stable_topk


def kalman_update(
    state: EkfState,
    obs: Observations,
    use: torch.Tensor,  # [K] bool — which measurements to apply
    std_z: float = 1.0,
    max_slots: int | None = None,
) -> EkfState:
    """Batch KF update over the selected measurements.

    H is never materialized: row block i of H has nonzeros only in the
    camera block (2×13) and the landmark-i block (2×6), so P·Hᵀ and
    S = H·P·Hᵀ come from per-slot strip einsums. With S = L·Lᵀ and
    W = L⁻¹[P·Hᵀ | ν]ᵀ, i.e. Y = L⁻¹(P·Hᵀ)ᵀ and w = L⁻¹ν from ONE
    triangular solve, the update is x + Yᵀw (= x + P·Hᵀ·S⁻¹ν) and the
    posterior P − YᵀY, symmetric PSD by construction. The Cholesky is the
    ``_ex`` form: its status stays on the device, as in the reference
    (which does not check it either).

    max_slots: bound the measurement stack to the M used slots (a stable
    top-k on the mask gathers every used slot first, ties in index
    order). Exact while ≤ M slots are in use; beyond that the
    highest-indexed surplus is dropped. None = full width.
    """
    k = obs.h.shape[0]
    d = state.x.shape[0]
    if max_slots is not None and max_slots < k:
        m = max_slots
        _, sel = stable_topk(use.to(torch.int32), m)  # used first
        sel_use = use[sel]  # [M]
        hc = torch.where(sel_use[:, None, None], obs.hc[sel], 0.0)
        hl = torch.where(sel_use[:, None, None], obs.hl[sel], 0.0)
        nu = torch.where(sel_use[:, None], (obs.z - obs.h)[sel],
                         0.0).reshape(-1)  # [2M]
        pc = state.p[:, :CAM_DIM]  # [D, 13]
        pl = state.p[:, CAM_DIM:].reshape(d, k, LM_DIM)[:, sel, :]
        ph = torch.einsum("dc,kec->dke", pc, hc) + torch.einsum(
            "dkl,kel->dke", pl, hl)  # [D, M, 2]
        ph2 = ph.reshape(d, 2 * m)
        phc = ph2[:CAM_DIM]  # [13, 2M]
        # landmark rows of P·Hᵀ for the selected slots only
        phl = ph2[CAM_DIM:].reshape(k, LM_DIM, 2 * m)[sel]  # [M, 6, 2M]
        n_rows = 2 * m
    else:
        hc = torch.where(use[:, None, None], obs.hc, 0.0)  # [K, 2, 13]
        hl = torch.where(use[:, None, None], obs.hl, 0.0)  # [K, 2, 6]
        nu = torch.where(use[:, None], obs.z - obs.h, 0.0).reshape(-1)
        pc = state.p[:, :CAM_DIM]  # [D, 13]
        pl = state.p[:, CAM_DIM:].reshape(d, k, LM_DIM)  # [D, K, 6]
        ph = torch.einsum("dc,kec->dke", pc, hc) + torch.einsum(
            "dkl,kel->dke", pl, hl)  # [D, K, 2] = P Hᵀ in per-slot layout
        ph2 = ph.reshape(d, 2 * k)
        phc = ph2[:CAM_DIM]  # [13, 2K]
        phl = ph2[CAM_DIM:].reshape(k, LM_DIM, 2 * k)  # [K, 6, 2K]
        n_rows = 2 * k
    s = (torch.einsum("kec,cm->kem", hc, phc)
         + torch.einsum("kel,klm->kem", hl, phl)).reshape(n_rows, n_rows)
    s = 0.5 * (s + s.T) + (std_z**2) * torch.eye(
        n_rows, dtype=s.dtype, device=s.device)
    # zeroed (unused) measurement rows leave σ² on the S diagonal and a
    # zero P·Hᵀ column: exact no-ops in the update.
    low, _ = torch.linalg.cholesky_ex(s)
    w = torch.linalg.solve_triangular(
        low, torch.cat([ph2.T, nu[:, None]], dim=1), upper=False)  # [2M, D+1]
    y, wnu = w[:, :d], w[:, d]
    x_new = state.x + y.T @ wnu
    p_new = state.p - y.T @ y
    p_new = 0.5 * (p_new + p_new.T)
    x_new, p_new = renormalize_quaternion(x_new, p_new)
    return state._replace(x=x_new, p=p_new)


def renormalize_quaternion(x: torch.Tensor, p: torch.Tensor):
    """Normalize the state quaternion and propagate its Jacobian through
    P (P ← J P Jᵀ, J = I except the q block, applied as strip updates)."""
    q = x[3:7]
    jn = jacfwd(qnormalize)(q)
    x = torch.cat([x[0:3], qnormalize(q), x[7:]])
    p = p.clone()
    p[3:7, :] = jn @ p[3:7, :]  # [4, D]
    p[:, 3:7] = p[:, 3:7] @ jn.T
    return x, p
