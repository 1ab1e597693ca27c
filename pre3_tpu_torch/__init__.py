"""pre3_tpu_torch — the PyTorch/CUDA port of pre3_tpu for one NVIDIA H100.

Same subpackages and module names as ``pre3_tpu`` (the JAX reference), so
every module's counterpart is found by path. Plain tensor code is PyTorch;
each Pallas kernel of the reference that the port has reached is a CUDA C++
kernel under ``csrc/`` with a plain-PyTorch twin beside its wrapper. The
package imports ``torch`` and never ``jax``.

Package layout (ported so far):
  data/      SR4000 Frame + synthetic scene renderer (numpy copies)
  eval/      ATE/RPE metrics (numpy copy)
  geometry/  quaternion, SE(3), camera model, inverse-depth landmarks
  frontend/  FAST detector, patch descriptors, scale space, SIFT, depth
             lift, pipeline
  ops/       3×3 SVD, small Cholesky, descriptor matching (CUDA kernel
             K2), RANSAC scoring (CUDA kernel K1)
  vo/        rigid fits, batched RANSAC, dead-reckoning VO, IFT covariance
  ekf/       EKF-SLAM: state, prediction, measurement, updates (Kalman,
             iterated, attitude), 1-point RANSAC, map management,
             slam_step / run_slam
  backend/   floor-plane fit (the EKF's orientation prior and attitude
             update)
  runtime/   OnlineSlam, the frame-by-frame streaming driver
  utils/     numpy ↔ torch interop with the reference's NamedTuples,
             stable top-k, nvcc build, async host constants, checkpoints,
             stage timing and profiler traces, chip tools
"""

import torch as _torch

# Estimation accuracy first, as in the reference (pre3_tpu/__init__.py:37,
# "highest" f32 matmuls): the engine's small-matrix math (Kabsch, SVD,
# pose chaining) must not run in TF32, which keeps ~3 decimal digits.
# cuBLAS f32 matmuls already default to full f32, but cuDNN convolutions
# default to TF32; both flags are set so neither path depends on defaults.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
# The step programs capture the EKF step into CUDA graphs: small solves
# (the attitude update's 3×3 system against a [3, D] right-hand side)
# would otherwise go to MAGMA's batched solver, which cannot be captured.
# cuSOLVER/cuBLAS serve every linalg call of the port instead (where
# torch is built for CUDA: a CPU build has neither).
if _torch.version.cuda is not None:
    _torch.backends.cuda.preferred_linalg_library("cusolver")

__version__ = "0.1.0"
