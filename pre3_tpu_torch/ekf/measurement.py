"""Measurement prediction, Jacobians, innovation covariance, and map
matching for the EKF.

Port of ``pre3_tpu/ekf/measurement.py``: h per landmark slot with its
visibility gate, the Jacobians ∂h/∂cam and ∂h/∂landmark by
``torch.func.vmap(torch.func.jacfwd(...))``, the innovation covariance S
assembled from the P blocks that H touches (H is never materialized), and
descriptor matching of the map against the frame (kernel K2), gated by
the predicted search region 3·√S.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from pre3_tpu_torch.ekf.state import CAM_DIM, LM_DIM, EkfState
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.camera import Camera, distort, project_point
from pre3_tpu_torch.geometry.inverse_depth import inverse_depth_camera_ray
from pre3_tpu_torch.geometry.quaternion import qconj, qrotate
from pre3_tpu_torch.ops.matching import match_descriptors_auto


class Observations(NamedTuple):
    """Per-frame transient measurement data."""

    h: torch.Tensor  # [K, 2] predicted pixel
    hc: torch.Tensor  # [K, 2, 13] ∂h/∂cam
    hl: torch.Tensor  # [K, 2, 6] ∂h/∂landmark
    s: torch.Tensor  # [K, 2, 2] innovation covariance
    visible: torch.Tensor  # [K] bool — predicted in image
    z: torch.Tensor  # [K, 2] matched measurement (0 where unmatched)
    ic: torch.Tensor  # [K] bool — individually compatible (matched)
    z_xyz: torch.Tensor  # [K, 3] camera-frame depth of the matched
    # feature (not used by the EKF update — recorded for the BA backend)


def _camera_ray(cam_state: torch.Tensor, lm: torch.Tensor,
                is_id: torch.Tensor) -> torch.Tensor:
    """Camera-frame direction of a landmark slot: the scale-free ray for
    inverse-depth slots, R_cwᵀ(p − t) for cartesian ones; a ``where`` over
    both, each NaN-safe for any slot content."""
    t_wc, q_wc = cam_state[..., 0:3], cam_state[..., 3:7]
    hrl_id = inverse_depth_camera_ray(lm, t_wc, q_wc)
    hrl_xyz = qrotate(qconj(q_wc), lm[..., :3] - t_wc)
    return torch.where(is_id[..., None], hrl_id, hrl_xyz)


def measure_one(
    cam_model: Camera, cam_state: torch.Tensor, lm: torch.Tensor,
    is_id: torch.Tensor,
) -> torch.Tensor:
    """Distorted-pixel measurement h of a landmark slot. Broadcasts over
    leading axes of ``cam_state`` [..., 13], ``lm`` [..., 6] and
    ``is_id`` [...]."""
    hrl = _camera_ray(cam_state, lm, is_id)
    return distort(cam_model, project_point(cam_model, hrl))


def _visible_gate(
    cam_model: Camera, cam_state: torch.Tensor, lm: torch.Tensor,
    is_id: torch.Tensor, h: torch.Tensor,
) -> torch.Tensor:
    """60° cone per axis + image bounds."""
    hrl = _camera_ray(cam_state, lm, is_id)
    zc = hrl[..., 2]
    okz = zc > 0
    limx = torch.abs(torch.rad2deg(torch.atan2(hrl[..., 0], zc))) < 60.0
    limy = torch.abs(torch.rad2deg(torch.atan2(hrl[..., 1], zc))) < 60.0
    u, v = h[..., 0], h[..., 1]
    inb = (u > 0) & (u < cam_model.n_cols - 1) & (v > 0) & (
        v < cam_model.n_rows - 1)
    return okz & limx & limy & inb


def predict_measurements(
    cam_model: Camera, state: EkfState, std_z: float = 1.0
) -> Observations:
    """h, H blocks, S, and visibility for every landmark slot."""
    cam_state = state.x[:CAM_DIM]
    lms = state.landmarks  # [K, 6]
    dev, dt = lms.device, lms.dtype

    def h_fn(c, l, iid):
        return measure_one(cam_model, c, l, iid)

    h = h_fn(cam_state, lms, state.is_id)  # [K, 2]
    hc = vmap(lambda l, i: jacfwd(lambda c: h_fn(c, l, i))(cam_state))(
        lms, state.is_id)  # [K, 2, 13]
    hl = vmap(lambda l, i: jacfwd(lambda ll: h_fn(cam_state, ll, i))(l))(
        lms, state.is_id)  # [K, 2, 6]
    # cartesian slots: no derivative with respect to the unused 3 params
    first3 = (torch.arange(LM_DIM, device=dev) < 3).to(dt)
    lm_mask = torch.where(state.is_id[:, None], 1.0, first3)
    hl = hl * lm_mask[:, None, :]

    # S_i = Hc Pcc Hcᵀ + Hc Pc,li Hlᵀ + (·)ᵀ + Hl Pli,li Hlᵀ + R
    k = state.n_landmarks
    pcc = state.p[:CAM_DIM, :CAM_DIM]
    pcl = state.p[:CAM_DIM, CAM_DIM:].reshape(CAM_DIM, k, LM_DIM)
    pcl = pcl.transpose(0, 1)  # [K, 13, 6]
    # diagonal 6×6 blocks of the landmark-landmark covariance as one
    # element gather
    rows = CAM_DIM + (torch.arange(k, device=dev)[:, None] * LM_DIM
                      + torch.arange(LM_DIM, device=dev)[None, :])  # [K, 6]
    pll_diag = state.p[rows[:, :, None], rows[:, None, :]]  # [K, 6, 6]
    s = (
        torch.einsum("kac,cd,kbd->kab", hc, pcc, hc)
        + torch.einsum("kac,kcd,kbd->kab", hc, pcl, hl)
        + torch.einsum("kad,kcd,kbc->kab", hl, pcl, hc)
        + torch.einsum("kac,kcd,kbd->kab", hl, pll_diag, hl)
        + (std_z**2) * torch.eye(2, dtype=dt, device=dev)[None]
    )

    visible = _visible_gate(cam_model, cam_state, lms, state.is_id, h)
    visible = visible & state.active
    return Observations(
        h=h, hc=hc, hl=hl, s=s, visible=visible,
        z=torch.zeros((k, 2), dtype=dt, device=dev),
        ic=torch.zeros(k, dtype=torch.bool, device=dev),
        z_xyz=torch.zeros((k, 3), dtype=dt, device=dev),
    )


def search_ic_matches(
    obs: Observations,
    state: EkfState,
    frame: Features,
    ratio: float = 1.5,
    gate_sigma: float = 3.0,
    max_gate_px: float = 40.0,
    gate_first: bool = False,
) -> tuple[Observations, EkfState]:
    """Match stored landmark descriptors to the frame's features, gated by
    the predicted search region; refresh the stored descriptor of every
    match.

    gate_first=False is the reference's order — global best descriptor
    match first (K2, no mask), search-region gate second. gate_first=True
    restricts the candidates to the gate before the ratio test (one
    [K, N] mask on the plain matcher)."""
    # search-region gate: 3σ of the innovation, clamped at 40 px
    sig = torch.sqrt(torch.clamp(
        torch.maximum(obs.s[:, 0, 0], obs.s[:, 1, 1]), min=1e-9))
    gate = torch.clamp(gate_sigma * sig, max=max_gate_px)
    pair_mask = None
    if gate_first:
        d_all = torch.linalg.vector_norm(
            frame.uv[None, :, :] - obs.h[:, None, :], dim=-1)  # [K, N]
        pair_mask = d_all <= gate[:, None]
    m = match_descriptors_auto(
        state.desc, frame.desc, valid1=obs.visible, valid2=frame.valid,
        ratio=ratio, pair_mask=pair_mask,
    )
    z = frame.uv[m.index]  # [K, 2]
    dist = torch.linalg.vector_norm(z - obs.h, dim=-1)
    ic = m.accepted & obs.visible & (dist <= gate)
    new_desc = torch.where(ic[:, None], frame.desc[m.index], state.desc)
    z_xyz = torch.where(ic[:, None], frame.xyz[m.index], 0.0)
    return (
        obs._replace(z=torch.where(ic[:, None], z, 0.0), ic=ic, z_xyz=z_xyz),
        state._replace(desc=new_desc),
    )
