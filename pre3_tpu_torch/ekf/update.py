"""EKF updates: masked batch Kalman update, heading and attitude
observations, the iterated update, and the quaternion renorm.

Port of ``pre3_tpu/ekf/update.py``. Excluded measurements are
zero-padded: zero H rows and zero innovation with unit R make a
measurement an exact no-op, so the [2K, D] system has a static shape.
Linear solves use the ``_ex`` forms, whose status stays on the device.
"""

from __future__ import annotations

import math

import torch
from torch.func import grad, jacfwd

from pre3_tpu_torch.ekf.measurement import Observations, predict_measurements
from pre3_tpu_torch.ekf.state import CAM_DIM, LM_DIM, EkfState
from pre3_tpu_torch.geometry.quaternion import q2e, qconj, qnormalize, qrotate
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


def assemble_h(obs: Observations, use: torch.Tensor) -> torch.Tensor:
    """Dense stacked H [K·2, D] with rows zeroed outside ``use``: landmark
    j's block sits at the static column of slot j."""
    k = obs.h.shape[0]
    hc = torch.where(use[:, None, None], obs.hc, 0.0)  # [K, 2, 13]
    hl = torch.where(use[:, None, None], obs.hl, 0.0)  # [K, 2, 6]
    eye = torch.eye(k, dtype=hl.dtype, device=hl.device)
    hlm = hl[:, :, None, :] * eye[:, None, :, None]  # [K, 2, K, 6]
    h = torch.cat([hc, hlm.reshape(k, 2, k * LM_DIM)], dim=-1)
    return h.reshape(k * 2, CAM_DIM + k * LM_DIM)


def heading_update(
    state: EkfState,
    z_heading: torch.Tensor,  # [] observed yaw, radians
    std_heading: float = 0.0349,  # ≈2°
) -> EkfState:
    """Scalar heading (yaw) observation update; the innovation is wrapped
    to (−π, π]. H is the gradient of the state's yaw."""

    def h_of(x):
        return q2e(x[3:7])[2]

    h = h_of(state.x)
    hrow = grad(h_of)(state.x)[None, :]  # [1, D]
    nu = torch.remainder(z_heading - h + math.pi, 2 * math.pi) - math.pi
    s = (hrow @ state.p @ hrow.T)[0, 0] + std_heading**2
    kgain = (state.p @ hrow.T)[:, 0] / s  # [D]
    x_new = state.x + kgain * nu
    p_new = state.p - s * torch.outer(kgain, kgain)
    p_new = 0.5 * (p_new + p_new.T)
    x_new, p_new = renormalize_quaternion(x_new, p_new)
    return state._replace(x=x_new, p=p_new)


def attitude_update(
    state: EkfState,
    up_cam: torch.Tensor,  # [3] observed camera-frame 'up' (floor normal)
    ok: torch.Tensor | bool = True,  # [] observation validity gate
    std_up: float = 0.0175,  # ≈1° direction noise
    max_angle_deg: float = 4.0,
) -> EkfState:
    """Gravity-direction observation update from a floor-plane fit: the
    observed camera-frame up axis against the one predicted from the
    filter's orientation. An innovation beyond max_angle_deg (or ok
    false) leaves the state as it was — selected on the device, no host
    branch."""
    dev, dt = state.x.device, state.x.dtype
    up_world = torch.zeros(3, dtype=dt, device=dev)
    up_world[1].fill_(-1.0)  # y-down convention

    def h_of(q):
        return qrotate(qconj(q), up_world)

    q = state.x[3:7]
    h = h_of(q)
    jq = jacfwd(h_of)(q)  # [3, 4]
    d = state.x.shape[0]
    hrow = torch.zeros((3, d), dtype=dt, device=dev)
    hrow[:, 3:7] = jq
    z = up_cam / torch.clamp(torch.linalg.vector_norm(up_cam), min=1e-9)
    nu = z - h
    angle = torch.arccos(torch.clamp(torch.dot(z, h), -1.0, 1.0))
    gate = angle < math.radians(max_angle_deg)

    s = hrow @ state.p @ hrow.T + (std_up**2) * torch.eye(
        3, dtype=dt, device=dev)
    kgain = torch.linalg.solve_ex(s, hrow @ state.p)[0].T  # [D, 3]
    x_new = state.x + kgain @ nu
    p_new = state.p - kgain @ s @ kgain.T
    p_new = 0.5 * (p_new + p_new.T)
    x_new, p_new = renormalize_quaternion(x_new, p_new)
    apply = gate & ok
    return state._replace(x=torch.where(apply, x_new, state.x),
                          p=torch.where(apply, p_new, state.p))


def iterated_kalman_update(
    cam_model,
    state: EkfState,
    z: torch.Tensor,  # [K, 2] measurements
    use: torch.Tensor,  # [K] bool
    n_iters: int = 3,
    std_z: float = 1.0,
) -> EkfState:
    """Iterated EKF update: h and H re-linearized at the running posterior
    mean, x_{j+1} = x̂ + K_j (ν_j − H_j (x̂ − x_j)); the covariance from
    the last linearization. Dense [2K, D] H, as the reference."""
    x_prior, p_prior = state.x, state.p
    st_j = state
    for _ in range(n_iters):
        obs_j = predict_measurements(cam_model, st_j, std_z=std_z)
        h = assemble_h(obs_j, use)  # [2K, D]
        nu = torch.where(use[:, None], z - obs_j.h, 0.0).reshape(-1)
        k2 = h.shape[0]
        r = (std_z**2) * torch.eye(k2, dtype=h.dtype, device=h.device)
        ph_t = p_prior @ h.T
        s = h @ ph_t + r
        kt = torch.linalg.solve_ex(s, ph_t.T)[0]  # [2K, D]
        dx = kt.T @ (nu - h @ (x_prior - st_j.x))
        st_j = st_j._replace(x=x_prior + dx)
    p_new = p_prior - kt.T @ s @ kt
    p_new = 0.5 * (p_new + p_new.T)
    x_new, p_new = renormalize_quaternion(st_j.x, p_new)
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
