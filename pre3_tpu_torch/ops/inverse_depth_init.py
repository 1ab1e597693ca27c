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

For CUDA tensors the wrapper goes through the custom op
``pre3_tpu_torch::inverse_depth_init``, so ``torch.func.vmap``
(``run_slam_batched``) reaches the kernel: the op's vmap rule moves the
batch axis to the front and calls the op again with that leading sequence
axis, ONE launch of K3. The op takes one sequence axis at most, so nested
vmap raises. On the CPU the op computes the plain version per sequence,
but the wrapper calls the plain version itself (under vmap, batched by
vmap as the step always was): the op's CPU kernel runs below autograd,
where a dispatch mode (``utils/graphs.py``'s op trail) leaves ``jacfwd``
no forward-mode autograd, and ``jacfwd`` cannot run inside a vmap rule.
The camera's intrinsics pass as Python floats, the rule of
``geometry/camera.py``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.func import jacfwd, vmap

from pre3_tpu_torch.ekf.state import CAM_DIM, LM_DIM
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.inverse_depth import inverse_depth_point
from pre3_tpu_torch.utils.cuda_build import load_library
from pre3_tpu_torch.utils.launch_count import Counted
from pre3_tpu_torch.utils.vmap_ops import check_not_batched, to_front


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


def _lib() -> ctypes.CDLL:
    lib = load_library("inverse_depth_init")
    fn = lib.inverse_depth_init_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float] * 5 + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
        floor = lib.inverse_depth_init_floor_launch
        floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        floor.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple,
           device: torch.device) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != shape or (
        x.device != device or not x.is_contiguous()
    ):
        raise ValueError(
            f"inverse_depth_init: {name} must be a contiguous float32 tensor "
            f"of shape {shape} on {device}; got {x.dtype} {tuple(x.shape)} "
            f"on {x.device}, contiguous={x.is_contiguous()}")


def _launch(cam: Camera, uv, cam13, rho):
    """K3 on CUDA tensors: one problem (uv [A, 2], cam13 [13], rho [A])
    or, with a leading sequence axis on every argument, S problems in one
    launch. Raises on what the kernel does not take, on a vmapped tensor,
    and on a failed launch."""
    check_not_batched("inverse_depth_init", uv, cam13, rho)
    device = uv.device
    if device.type != "cuda":
        raise ValueError(f"inverse_depth_init: no kernel for device {device}")
    lead = tuple(uv.shape[:-2])  # () or (S,)
    if len(lead) > 1 or uv.dim() < 2:
        raise ValueError(f"inverse_depth_init: uv must be [A, 2] or "
                         f"[S, A, 2]; got {tuple(uv.shape)}")
    a = uv.shape[-2]
    _check("uv", uv, (*lead, a, 2), device)
    _check("cam13", cam13, (*lead, CAM_DIM), device)
    _check("rho", rho, (*lead, a), device)
    out = [torch.empty((*lead, a, *tail), dtype=torch.float32, device=device)
           for tail in ((LM_DIM,), (LM_DIM, CAM_DIM), (LM_DIM, 2), (LM_DIM,))]
    n_seq = lead[0] if lead else 1
    if a == 0 or n_seq == 0:
        return tuple(out)
    lib = _lib()
    count = inverse_depth_init.pointer(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.inverse_depth_init_launch(
            uv.data_ptr(), cam13.data_ptr(), rho.data_ptr(), n_seq, a,
            cam.f, cam.cx, cam.cy, cam.k1, cam.k2,
            *(o.data_ptr() for o in out), stream, count)
    if rc != 0:
        raise RuntimeError(f"inverse_depth_init kernel launch failed: "
                           f"cudaError {rc} (S={n_seq}, A={a})")
    return tuple(out)


def _run(uv, cam13, rho, *intrinsics):
    """What the custom op computes: K3 on the card, one launch for one
    problem or for a leading sequence axis; on the CPU the plain version,
    per sequence for a sequence axis. A second leading axis (nested vmap)
    raises."""
    if uv.dim() > 3:
        raise RuntimeError(
            f"inverse_depth_init: nested vmap is not supported; the kernel "
            f"takes one sequence axis (uv {tuple(uv.shape)})")
    cam = Camera(*intrinsics)
    if uv.device.type != "cpu":
        return _launch(cam, uv, cam13, rho)
    if uv.dim() == 2:
        return inverse_depth_init_torch(cam, uv, cam13, rho)
    rows = [inverse_depth_init_torch(cam, *xs) for xs in zip(uv, cam13, rho)]
    return tuple(torch.stack(col) for col in zip(*rows))


@torch.library.custom_op(
    "pre3_tpu_torch::inverse_depth_init", mutates_args=(),
    schema="(Tensor uv, Tensor cam13, Tensor rho, float f, float cx, "
           "float cy, float k1, float k2, int n_rows, int n_cols) -> "
           "(Tensor, Tensor, Tensor, Tensor)")
def _init_op(uv, cam13, rho, f, cx, cy, k1, k2, n_rows, n_cols):
    return _run(uv, cam13, rho, f, cx, cy, k1, k2, n_rows, n_cols)


@_init_op.register_fake
def _fake(uv, cam13, rho, *intrinsics):
    lead = uv.shape[:-1]  # (..., A)
    return tuple(uv.new_empty((*lead, *tail)) for tail in (
        (LM_DIM,), (LM_DIM, CAM_DIM), (LM_DIM, 2), (LM_DIM,)))


@_init_op.register_vmap
def _init_vmap(info, in_dims, uv, cam13, rho, *intrinsics):
    args = to_front(info.batch_size, in_dims[:3], (uv, cam13, rho))
    return _init_op(*args, *intrinsics), (0, 0, 0, 0)


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
    if uv.device.type == "cpu":
        return inverse_depth_init_torch(cam, uv, cam13, rho)
    if uv.device.type != "cuda":
        raise ValueError(f"inverse_depth_init: no kernel for device "
                         f"{uv.device}")
    return _init_op(uv, cam13, rho, *(float(x) for x in cam[:5]),
                    int(cam.n_rows), int(cam.n_cols))
