"""New inverse-depth landmarks and their Jacobians (kernel K3).

``add_features`` initializes each candidate landmark y = [t_wc, θ, φ, ρ]
from a distorted pixel, the camera and a depth prior, with the three
Jacobians the covariance augmentation needs:

  inverse_depth_init_torch — the plain PyTorch version: the value of
                             ``inverse_depth_point`` and three
                             ``vmap(jacfwd)`` passes over it (camera,
                             pixel, ρ). The CPU path and the kernel's
                             oracle.
  inverse_depth_init       — the wrapper: CPU tensors go to the plain
                             version, CUDA tensors launch the hand-written
                             kernel ``csrc/inverse_depth_init.cu`` or
                             raise. It replaces the ~1300 small kernels of
                             the four passes with one launch.

CUDA tensors go through the custom op ``pre3_tpu_torch::inverse_depth_init``,
whose vmap rule makes one launch of K3 for S sequences
(``run_slam_batched``; ``ops/kernel_op.py``, which K1–K4 share). CPU
tensors go to the plain version, under vmap batched by vmap: the op's
CPU kernel runs below autograd, where a dispatch mode (``utils/graphs.py``'s
op trail) leaves ``jacfwd`` no forward-mode autograd, and ``jacfwd``
cannot run inside a vmap rule. The camera's intrinsics pass as Python
floats, the rule of ``geometry/camera.py``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.func import jacfwd, vmap

from pre3_tpu_torch.ekf.state import CAM_DIM, LM_DIM
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.inverse_depth import inverse_depth_point
from pre3_tpu_torch.ops.kernel_op import HandKernel
from pre3_tpu_torch.utils.launch_count import Counted


def inverse_depth_init_torch(
    cam: Camera,
    uv: torch.Tensor,  # [A, 2] distorted pixels
    cam13: torch.Tensor,  # [13] the camera state
    rho: torch.Tensor,  # [A] inverse-depth priors
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (y [A, 6], ∂y/∂cam [A, 6, 13], ∂y/∂uv [A, 6, 2],
    ∂y/∂ρ [A, 6])."""

    def y_of(c, uv_, rho_):
        return inverse_depth_point(cam, uv_, c[0:3], c[3:7], rho_)

    y = y_of(cam13, uv, rho)
    jc = vmap(lambda u, r: jacfwd(lambda c: y_of(c, u, r))(cam13))(uv, rho)
    juv = vmap(lambda u, r: jacfwd(lambda uu: y_of(cam13, uu, r))(u))(
        uv, rho)
    jr = vmap(lambda u, r: jacfwd(lambda rr: y_of(cam13, u, rr))(r))(uv, rho)
    return y, jc, juv, jr


K3 = HandKernel("inverse_depth_init", "inverse_depth_init", arg="uv",
                shape="A, 2", inputs=3,
                scalars=[ctypes.c_int] + [ctypes.c_float] * 5, outputs=4,
                floor=[ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_TAILS = ((LM_DIM,), (LM_DIM, CAM_DIM), (LM_DIM, 2), (LM_DIM,))


def _launch(uv, cam13, rho, *intrinsics):
    """K3 on CUDA tensors: one problem (uv [A, 2], cam13 [13], rho [A])
    or, with a leading sequence axis on every argument, S problems in one
    launch. Raises on what the kernel does not take, on a vmapped tensor,
    and on a failed launch."""
    lead = K3.lead(uv, cam13, rho)
    device, a, cam = uv.device, uv.shape[-2], Camera(*intrinsics)
    K3.check("uv", uv, torch.float32, (*lead, a, 2), device)
    K3.check("cam13", cam13, torch.float32, (*lead, CAM_DIM), device)
    K3.check("rho", rho, torch.float32, (*lead, a), device)
    out = tuple(torch.empty((*lead, a, *tail), dtype=torch.float32,
                            device=device) for tail in _TAILS)
    K3.launch(inverse_depth_init, lead, (uv, cam13, rho), out, dict(A=a),
              (cam.f, cam.cx, cam.cy, cam.k1, cam.k2))
    return out


def _plain(uv, cam13, rho, *intrinsics):
    return inverse_depth_init_torch(Camera(*intrinsics), uv, cam13, rho)


def _fake(uv, cam13, rho, *intrinsics):
    return tuple(uv.new_empty((*uv.shape[:-1], *tail)) for tail in _TAILS)


K3.define("pre3_tpu_torch::inverse_depth_init",
          "(Tensor uv, Tensor cam13, Tensor rho, float f, float cx, "
          "float cy, float k1, float k2, int n_rows, int n_cols) -> "
          "(Tensor, Tensor, Tensor, Tensor)", _launch, _plain, _fake)


@Counted
def inverse_depth_init(
    cam: Camera,
    uv: torch.Tensor,
    cam13: torch.Tensor,
    rho: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Production initializer (used by ``ekf/map_management.py::
    add_features``): (y [A, 6], ∂y/∂cam [A, 6, 13], ∂y/∂uv [A, 6, 2],
    ∂y/∂ρ [A, 6]) from distorted pixels uv [A, 2], the camera state
    cam13 [13] and priors rho [A]. The CUDA kernel K3 for CUDA tensors,
    the plain version for CPU tensors; under ``torch.func.vmap`` one
    batched launch of K3 for all sequences. Nothing falls back: a CUDA input
    the kernel does not take raises.

    ``inverse_depth_init.launches`` counts the kernel's runs, added on the
    device by the kernel itself (``utils/launch_count``)."""
    if K3.on_cpu(uv):
        return inverse_depth_init_torch(cam, uv, cam13, rho)
    return K3.op(uv, cam13, rho, *(float(x) for x in cam[:5]),
                 int(cam.n_rows), int(cam.n_cols))
