"""EKF prediction with odometry (VO) control input.

Port of ``pre3_tpu/ekf/prediction.py``: the camera pose is propagated by
the frame-to-frame VO increment u = (dX, dq); landmarks are static. The
F and G Jacobians come from ``torch.func.jacfwd`` of the 13-dim
transition; covariance propagation touches only the camera row/column
strips, never the landmark-landmark block.

Process noise is the reference's hand-tuned constant: cov_dX =
diag((0.01/3)²) and cov_dq from Euler noise 0.24°/2·[1, 0.1, 1] pushed
through e2q.
"""

from __future__ import annotations

import math

import torch
from torch.func import jacfwd

from pre3_tpu_torch.ekf.state import CAM_DIM, EkfState
from pre3_tpu_torch.geometry.quaternion import (
    e2q, qnormalize, qprod, qrotate, v2q,
)
from pre3_tpu_torch.utils.device import cached_constant


def camera_transition(cam: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """13-dim camera transition under odometry control u = [dX(3), dq(4)]:
    r' = r + R(q)·dX, q' = q ⊗ dq; the velocity states pass through."""
    r, q = cam[0:3], cam[3:7]
    dx, dq = u[0:3], u[3:7]
    return torch.cat([r + qrotate(q, dx), qprod(q, dq), cam[7:13]])


def process_noise_u() -> torch.Tensor:
    """[7, 7] control-space noise Pn, on the CPU. As the reference: the
    Jacobian Qe = ∂q/∂e in float32 at the nominal Euler noise point, the
    product Qe diag(e²) Qeᵀ in float64, the result in float32."""
    cov_dx = torch.full((3,), (0.01 / 3.0) ** 2, dtype=torch.float64)
    e = 0.24 / 2.0 * math.pi / 180.0 * torch.tensor([1.0, 0.1, 1.0],
                                                     dtype=torch.float64)
    qe = jacfwd(e2q)(e.to(torch.float32)).to(torch.float64)
    cov_dq = qe @ torch.diag(e**2) @ qe.T
    pn = torch.zeros((7, 7), dtype=torch.float64)
    pn[:3, :3] = torch.diag(cov_dx)
    pn[3:, 3:] = cov_dq
    return pn.to(torch.float32)


def process_noise_on(device) -> torch.Tensor:
    """``process_noise_u()`` on ``device``, built once per device."""
    return cached_constant("process_noise_u", process_noise_u, device)


def _norm_jac(q: torch.Tensor) -> torch.Tensor:
    """Jacobian of quaternion normalization (the reference's normJac)."""
    return jacfwd(qnormalize)(q)


def _propagate(
    state: EkfState, cam_new: torch.Tensor, f: torch.Tensor,
    q_block: torch.Tensor,
) -> EkfState:
    """Blockwise covariance propagation + quaternion renorm shared by the
    odometry and constant-velocity predictions: only the camera row and
    column strips are rewritten; the landmark block passes through."""
    p = state.p
    pcc = p[:CAM_DIM, :CAM_DIM]
    pcl = p[:CAM_DIM, CAM_DIM:]
    pcc_n = f @ pcc @ f.T + q_block
    pcl_n = f @ pcl
    # I₁₃ with the normalization Jacobian at [3:7, 3:7], built out of
    # place so that vmap can batch it
    eye = torch.eye(CAM_DIM, dtype=p.dtype, device=p.device)
    jfull = torch.cat([eye[0:3], torch.cat([
        eye[3:7, 0:3], _norm_jac(cam_new[3:7]), eye[3:7, 7:]], 1), eye[7:]])
    pcc_n = jfull @ pcc_n @ jfull.T
    pcl_n = jfull @ pcl_n
    pcc_n = 0.5 * (pcc_n + pcc_n.T)
    p_new = p.clone()
    p_new[:CAM_DIM, :CAM_DIM] = pcc_n
    p_new[:CAM_DIM, CAM_DIM:] = pcl_n
    p_new[CAM_DIM:, :CAM_DIM] = pcl_n.T
    cam_new = torch.cat([cam_new[0:3], qnormalize(cam_new[3:7]),
                         cam_new[7:CAM_DIM]])
    x_new = torch.cat([cam_new, state.x[CAM_DIM:]])
    return state._replace(x=x_new, p=p_new)


def camera_transition_cv(cam: torch.Tensor, n: torch.Tensor,
                         dt: float) -> torch.Tensor:
    """Constant-velocity transition with acceleration impulse
    n = [a(3), α(3)]: v' = v + a·Δt, ω' = ω + α·Δt, r' = r + v'·Δt,
    q' = q ⊗ v2q(ω'·Δt)."""
    r, q = cam[0:3], cam[3:7]
    v2 = cam[7:10] + n[0:3] * dt
    w2 = cam[10:13] + n[3:6] * dt
    return torch.cat([r + v2 * dt, qprod(q, v2q(w2 * dt)), v2, w2])


def predict_cv(
    state: EkfState,
    dt: float = 0.1,
    std_a: float = 0.1,
    std_alpha: float = 0.1,
) -> EkfState:
    """Constant-velocity EKF prediction (the estimator with no odometry
    input): v/ω propagate the pose and take the acceleration random-walk
    noise."""
    cam = state.x[:CAM_DIM]
    zero6 = torch.zeros(6, dtype=cam.dtype, device=cam.device)
    cam_new = camera_transition_cv(cam, zero6, dt)
    f = jacfwd(lambda c: camera_transition_cv(c, zero6, dt))(cam)
    g = jacfwd(lambda n: camera_transition_cv(cam, n, dt))(zero6)
    pn = torch.diag(torch.cat([
        torch.full((3,), std_a**2, dtype=cam.dtype, device=cam.device),
        torch.full((3,), std_alpha**2, dtype=cam.dtype, device=cam.device),
    ]))
    return _propagate(state, cam_new, f, g @ pn @ g.T)


def predict(state: EkfState, u: torch.Tensor,
            pn: torch.Tensor | None = None) -> EkfState:
    """One EKF prediction. u = [dX(3), dq(4)] VO increment (identity when
    VO failed). pn: optional [7, 7] control-space noise; default the
    reference's hand-tuned constant."""
    if pn is None:
        pn = process_noise_on(state.x.device)
    cam = state.x[:CAM_DIM]
    cam_new = camera_transition(cam, u)
    f = jacfwd(lambda c: camera_transition(c, u))(cam)  # [13, 13]
    g = jacfwd(lambda uu: camera_transition(cam, uu))(u)  # [13, 7]
    return _propagate(state, cam_new, f, g @ pn @ g.T)
