"""Masked fixed-capacity EKF-SLAM state.

Port of ``pre3_tpu/ekf/state.py``. The layout is static: K landmark
slots, each 6 wide.

  x: [D] with D = 13 + 6K
     camera: r(0:3) position, q(3:7) quaternion wxyz, v(7:10), ω(10:13)
     landmark slot i: x[13+6i : 19+6i]
       inverse-depth: [x0, y0, z0, θ, φ, ρ]
       cartesian:     [X, Y, Z, 0, 0, 0]   (after linearity conversion)
  p: [D, D] dense covariance (inactive slots carry zero rows/cols)

plus per-slot metadata. Add/delete are mask flips and block writes; free
slots are reused, nothing is compacted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CAM_DIM = 13
LM_DIM = 6


class EkfState(NamedTuple):
    x: torch.Tensor  # [D]
    p: torch.Tensor  # [D, D]
    active: torch.Tensor  # [K] bool
    is_id: torch.Tensor  # [K] bool — inverse-depth vs cartesian param'n
    desc: torch.Tensor  # [K, DD] stored descriptor per landmark
    times_predicted: torch.Tensor  # [K] int32
    times_measured: torch.Tensor  # [K] int32
    init_frame: torch.Tensor  # [K] int32
    last_visible: torch.Tensor  # [K] int32
    # Init-appearance record of the warped-patch NCC matcher (zero-filled
    # and unused in descriptor-matching mode).
    init_patch: torch.Tensor  # [K, PB, PB] raw intensity patch at init
    init_uv: torch.Tensor  # [K, 2] pixel at init
    init_cam: torch.Tensor  # [K, 7] (t_w, q_wc) camera pose at init

    @property
    def n_landmarks(self) -> int:
        return self.active.shape[0]

    @property
    def cam(self) -> torch.Tensor:
        return self.x[:CAM_DIM]

    @property
    def r_wc(self) -> torch.Tensor:
        return self.x[0:3]

    @property
    def q_wc(self) -> torch.Tensor:
        return self.x[3:7]

    @property
    def landmarks(self) -> torch.Tensor:
        """[K, 6] landmark parameter blocks."""
        return self.x[CAM_DIM:].reshape(-1, LM_DIM)


def init_state(
    n_landmarks: int = 64,
    desc_dim: int = 128,
    q0: torch.Tensor | None = None,
    std_v0: float = 0.025,
    std_w0: float = 0.025,
    patch_big: int = 21,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> EkfState:
    """x₀/P₀: zero pose (optionally the plane-fit orientation prior q0),
    eps on the pose covariance, 0.025² on the velocity covariances.
    Constants are written with ``fill_``, so nothing is copied from the
    host."""
    k = n_landmarks
    d = CAM_DIM + LM_DIM * k
    x = torch.zeros(d, dtype=dtype, device=device)
    if q0 is None:
        x[3].fill_(1.0)
    else:
        x[3:7] = q0
    x[10:13].fill_(1e-15)  # w_0, the reference's tiny epsilon
    pdiag = torch.zeros(d, dtype=dtype, device=device)
    pdiag[0:7].fill_(1e-7)
    pdiag[7:10].fill_(std_v0**2)
    pdiag[10:13].fill_(std_w0**2)
    zi = torch.zeros(k, dtype=torch.int32, device=device)
    zb = torch.zeros(k, dtype=torch.bool, device=device)
    return EkfState(
        x=x, p=torch.diag(pdiag), active=zb, is_id=zb.clone(),
        desc=torch.zeros((k, desc_dim), dtype=dtype, device=device),
        times_predicted=zi, times_measured=zi.clone(), init_frame=zi.clone(),
        last_visible=zi.clone(),
        init_patch=torch.zeros((k, patch_big, patch_big), dtype=dtype,
                               device=device),
        init_uv=torch.zeros((k, 2), dtype=dtype, device=device),
        init_cam=torch.zeros((k, 7), dtype=dtype, device=device),
    )
