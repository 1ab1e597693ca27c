"""The IFT covariance of the VO increment (kernel K4).

``vo/dead_reckoning.py::vo_pair`` (and loop mining's ``pair_fit``) turn
the RANSAC rigid fit (R, t) over the matched points into the [6, 6]
covariance of the increment θ = [dt, dω] (``vo/covariance.py``):

  vo_covariance_torch       — the plain version in ``vo/covariance.py``:
                              ``hessian`` and two ``jacfwd``-of-``grad``
                              passes over all N points. The CPU path and
                              the kernel's oracle.
  vo_covariance_closed_form — the same derivatives written out (below),
                              in plain PyTorch and in float64, as
                              ``csrc/vo_covariance.cu`` computes them: the
                              custom op's CPU kernel.
  vo_covariance             — the wrapper: CPU tensors go to the plain
                              version, CUDA tensors launch the
                              hand-written kernel or raise. It replaces
                              the ~800 small kernels of the ``torch.func``
                              passes with one launch.

The closed form, at θ = 0 with qᵢ = R·p2ᵢ, eᵢ = p1ᵢ − qᵢ − t and
Jᵢ = [I₃, −[qᵢ]×] (the residual's derivative is −Jᵢ):

  A    = Σ wᵢ JᵢᵀJᵢ, its ω block less Σ wᵢ (½(eᵢqᵢᵀ + qᵢeᵢᵀ) − (eᵢ·qᵢ) I₃),
         the second-order term of ``qrotate(v2q(ω), ·)`` against the
         residual;
  B1ᵢ  = ∂g/∂p1ᵢ = −wᵢ [I₃; [qᵢ]×],   B2ᵢ = ∂g/∂p2ᵢ = wᵢ [I₃; [p1ᵢ − t]×] R;
  mid  = Σ B1ᵢ S(p1ᵢ) B1ᵢᵀ + B2ᵢ S(p2ᵢ) B2ᵢᵀ  (S: ``sr4000_point_covariance``);
  cov  = sym((A + 1e-6 I)⁻¹ mid (A + 1e-6 I)⁻ᵀ).

CUDA tensors go through the custom op ``pre3_tpu_torch::vo_covariance``,
whose vmap rule makes one launch of K4 for S sequences
(``run_slam_batched``; ``ops/kernel_op.py``, which K1–K4 share). CPU
tensors go to the ``torch.func`` version, under vmap batched by vmap, bit
for bit what the port computed before K4; the op's CPU kernel runs below
autograd, where ``torch.func`` cannot run, so it computes the closed form.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pre3_tpu_torch.ops.kernel_op import HandKernel
from pre3_tpu_torch.utils.launch_count import Counted
from pre3_tpu_torch.vo.covariance import (
    DAMPING, SIGMA_ANG, SIGMA_RANGE, sr4000_point_covariance,
    vo_covariance_torch,
)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] → [..., 3, 3] with [v]× u = v × u."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def vo_covariance_closed_form(
    r: torch.Tensor,  # [..., 3, 3] fitted rotation
    t: torch.Tensor,  # [..., 3] fitted translation
    p1: torch.Tensor,  # [..., N, 3] frame-1 points
    p2: torch.Tensor,  # [..., N, 3] frame-2 points
    w: torch.Tensor,  # [..., N] inlier weights
) -> torch.Tensor:
    """[..., 6, 6] covariance of the VO increment [dt, dω] from the
    derivatives written out (module docstring); any leading axes. As K4
    does, it computes in float64 and returns the inputs' dtype: with few
    or nearly collinear inliers an ill-conditioned A, inverted in
    float32, lands up to ~3e-4 of max |cov| from the float64 value."""
    dtype = p1.dtype
    r, t, p1, p2, w = (x.to(torch.float64) for x in (r, t, p1, p2, w))
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device)
    q = torch.einsum("...ij,...nj->...ni", r, p2)
    e = p1 - q - t[..., None, :]
    qx = _skew(q)
    jac = torch.cat([eye.expand(qx.shape), -qx], dim=-1)  # [..., N, 3, 6]
    a = torch.einsum("...n,...nia,...nib->...ab", w, jac, jac)
    eq = e[..., :, None] * q[..., None, :]
    second = 0.5 * (eq + eq.mT) - torch.sum(e * q, -1)[..., None, None] * eye
    a = a - F.pad(torch.einsum("...n,...nij->...ij", w, second), (3, 0, 3, 0))
    wn = w[..., None, None]
    b1 = -wn * torch.cat([eye.expand(qx.shape), qx], dim=-2)  # [..., N, 6, 3]
    b2 = wn * (torch.cat([eye.expand(qx.shape),
                          _skew(p1 - t[..., None, :])], dim=-2)
               @ r[..., None, :, :])
    mid = (torch.einsum("...naj,...njk,...nbk->...ab", b1,
                        sr4000_point_covariance(p1), b1)
           + torch.einsum("...naj,...njk,...nbk->...ab", b2,
                          sr4000_point_covariance(p2), b2))
    a_inv, _ = torch.linalg.inv_ex(
        a + DAMPING * torch.eye(6, dtype=a.dtype, device=a.device))
    cov = a_inv @ mid @ a_inv.mT
    return (0.5 * (cov + cov.mT)).to(dtype)


K4 = HandKernel("vo_covariance", "vo_covariance", arg="r", shape="3, 3",
                inputs=5, scalars=[ctypes.c_int] + [ctypes.c_double] * 3,
                outputs=1, floor=[ctypes.c_int, ctypes.c_void_p])


def _launch(r, t, p1, p2, w):
    """K4 on CUDA tensors: one problem (r [3, 3], t [3], p1 and p2
    [N, 3], w [N]) or, with a leading sequence axis on every argument, S
    problems in one launch. Raises on what the kernel does not take, on a
    vmapped tensor, and on a failed launch."""
    lead = K4.lead(r, t, p1, p2, w)
    device, n = r.device, p1.shape[-2]
    K4.check("r", r, torch.float32, (*lead, 3, 3), device)
    K4.check("t", t, torch.float32, (*lead, 3), device)
    K4.check("p1", p1, torch.float32, (*lead, n, 3), device)
    K4.check("p2", p2, torch.float32, (*lead, n, 3), device)
    K4.check("w", w, torch.float32, (*lead, n), device)
    out = torch.empty((*lead, 6, 6), dtype=torch.float32, device=device)
    K4.launch(vo_covariance, lead, (r, t, p1, p2, w), (out,), dict(N=n),
              (SIGMA_RANGE**2, SIGMA_ANG, DAMPING))
    return out


def _fake(r, t, p1, p2, w):
    return p1.new_empty((*p1.shape[:-2], 6, 6))


K4.define("pre3_tpu_torch::vo_covariance",
          "(Tensor r, Tensor t, Tensor p1, Tensor p2, Tensor w) -> Tensor",
          _launch, vo_covariance_closed_form, _fake)


@Counted
def vo_covariance(
    r: torch.Tensor,  # [3, 3] fitted rotation
    t: torch.Tensor,  # [3] fitted translation
    p1: torch.Tensor,  # [N, 3] frame-1 points
    p2: torch.Tensor,  # [N, 3] frame-2 points
    w: torch.Tensor,  # [N] inlier weights
) -> torch.Tensor:
    """Production covariance of the VO increment [dt, dω], [6, 6]. The
    CUDA kernel K4 for CUDA tensors, the plain ``torch.func`` version for
    CPU tensors; under ``torch.func.vmap`` one batched launch of K4 for
    all sequences. Nothing falls back: a CUDA input the kernel does not
    take raises.

    ``vo_covariance.launches`` counts the kernel's runs, added on the
    device by the kernel itself (``utils/launch_count``)."""
    if K4.on_cpu(p1):
        return vo_covariance_torch(r, t, p1, p2, w)
    return K4.op(r, t, p1, p2, w)
