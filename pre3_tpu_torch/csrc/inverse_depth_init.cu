// New inverse-depth landmarks and their Jacobians (kernel K3) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this inside the jitted
// step (pre3_tpu/ekf/map_management.py::add_features, the value of
// inverse_depth_point and three vmap(jacfwd) passes over it). The port's
// plain version (ops/inverse_depth_init.py::inverse_depth_init_torch) runs
// the same four passes, ~1300 tiny kernels in every captured step graph;
// this kernel does them in one launch. For each candidate (sequence s,
// candidate a):
//
//   y      [6]     = [t_wc, theta, phi, rho]  (inverse_depth_point)
//   dy/dcam [6, 13] (the 13-vector camera: t, q, v, w)
//   dy/duv  [6, 2]  (the distorted pixel)
//   dy/drho [6]
//
// exactly as torch.func.jacfwd defines them: the undistortion's fixed
// 10 Newton steps run as written, and the two pixel tangents ride along
// through every step, through rd = sqrt(...) and through the final safe_d
// division (forward mode, not the fixed point's 1/f'(r_u)). The rotation
// is qrotate's own formula v + w t + q_v x t with t = 2 q_v x v,
// differentiated in the four q entries as they stand (q need not be unit
// length). theta and phi go through atan2 as angles_from_ray has them.
// The t rows are the identity in cam[0:3], camera columns 7-12 are zero,
// and dy/drho is e_6.
//
// What bounds it on this card: at most 8 candidates per step (32 at the
// bootstrap) of a few hundred flops each, ~100 output floats per
// candidate: nothing but the launch and one thread's chain of dependent
// divisions. One thread per (sequence, candidate), in registers; no shared
// memory, no atomics but the launch counter, no reductions, so a replayed
// graph gives the same bits every time.
//
// f32 with precise sqrtf and atan2f and IEEE division (the build passes no
// --use_fast_math; nothing here needs sin or cos). The intrinsics arrive
// as arguments, as geometry/camera.py's functions take them.
//
// Layouts (contiguous, float32): uv [S, A, 2], cam13 [S, 13], rho [S, A]
// -> y [S, A, 6], jc [S, A, 6, 13], juv [S, A, 6, 2], jr [S, A, 6]. A
// single problem is S = 1.
//
// Plain C interface, loaded with ctypes (pre3_tpu_torch/utils/cuda_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kNewtonSteps = 10;  // geometry/camera.py::undistort's default
constexpr int kCam = 13;
constexpr int kLm = 6;

// A value and its tangents along u and along v (forward mode in the
// distorted pixel).
struct Dual {
  float x, du, dv;
};

__device__ __forceinline__ Dual dual(float x) { return {x, 0.0f, 0.0f}; }

__device__ __forceinline__ Dual add(Dual a, Dual b) {
  return {a.x + b.x, a.du + b.du, a.dv + b.dv};
}

__device__ __forceinline__ Dual sub(Dual a, Dual b) {
  return {a.x - b.x, a.du - b.du, a.dv - b.dv};
}

__device__ __forceinline__ Dual mul(Dual a, Dual b) {
  return {a.x * b.x, a.du * b.x + a.x * b.du, a.dv * b.x + a.x * b.dv};
}

__device__ __forceinline__ Dual scale(float c, Dual a) {
  return {c * a.x, c * a.du, c * a.dv};
}

__device__ __forceinline__ Dual div(Dual a, Dual b) {
  const float q = a.x / b.x;
  return {q, (a.du - q * b.du) / b.x, (a.dv - q * b.dv) / b.x};
}

// sqrt's tangent t / (2 sqrt(x)): 0/0 = NaN at x = 0, as torch's is.
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const float r = sqrtf(a.x);
  return {r, a.du / (2.0f * r), a.dv / (2.0f * r)};
}

// a^2, a^3, a^4, a^5 with their tangents k a^(k-1) a'.
__device__ __forceinline__ Dual dpow(Dual a, int k) {
  float p = a.x, pm = 1.0f;  // a^k, a^(k-1)
  for (int i = 1; i < k; ++i) {
    pm = p;
    p *= a.x;
  }
  const float g = static_cast<float>(k) * pm;
  return {p, g * a.du, g * a.dv};
}

// atan2(y, x) and its tangent (x y' - y x') / (x^2 + y^2).
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  const float r = 1.0f / (x.x * x.x + y.x * y.x);
  return {atan2f(y.x, x.x), (x.x * y.du - y.x * x.du) * r,
          (x.x * y.dv - y.x * x.dv) * r};
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// qrotate(q, v) = v + w t + q_v x t, t = 2 q_v x v.
__device__ __forceinline__ void qrotate(float w, const float qv[3],
                                        const float v[3], float out[3]) {
  float t[3], c[3];
  cross(qv, v, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] *= 2.0f;
  cross(qv, t, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = v[k] + w * t[k] + c[k];
}

// theta = atan2(nx, nz), phi = atan2(-ny, sqrt(nx^2 + nz^2)) and their
// derivatives along dn: d theta = (nz dnx - nx dnz) / (nx^2 + nz^2),
// d phi = (s (-dny) + ny ds) / (ny^2 + s^2), ds = (nx dnx + nz dnz) / s.
__device__ __forceinline__ void angle_rates(const float n[3], float s,
                                           const float dn[3], float* dtheta,
                                           float* dphi) {
  const float rt = 1.0f / (n[0] * n[0] + n[2] * n[2]);
  const float rp = 1.0f / (s * s + n[1] * n[1]);
  const float ds = (n[0] * dn[0] + n[2] * dn[2]) / s;
  *dtheta = (n[2] * dn[0] - n[0] * dn[2]) * rt;
  *dphi = (s * -dn[1] + n[1] * ds) * rp;
}

template <bool kEmpty>
__global__ void __launch_bounds__(kThreads)
inverse_depth_init_kernel(const float* __restrict__ uv,     // [S, A, 2]
                          const float* __restrict__ cam13,  // [S, 13]
                          const float* __restrict__ rho,    // [S, A]
                          int S, int A, float f, float cx, float cy, float k1,
                          float k2,
                          float* __restrict__ y,    // [S, A, 6]
                          float* __restrict__ jc,   // [S, A, 6, 13]
                          float* __restrict__ juv,  // [S, A, 6, 2]
                          float* __restrict__ jr,   // [S, A, 6]
                          int32_t* __restrict__ launches) {  // [1] or null
  if constexpr (kEmpty) return;
  // the launch counter: one per launch, where the kernel runs (a replayed
  // CUDA graph counts too)
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(launches, 1);
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= S * A) return;
  const float* cam = cam13 + static_cast<size_t>(i / A) * kCam;

  // geometry/camera.py::undistort, the pixel tangents carried along
  const Dual xd = {(__ldg(uv + 2 * i) - cx) / f, 1.0f / f, 0.0f};
  const Dual yd = {(__ldg(uv + 2 * i + 1) - cy) / f, 0.0f, 1.0f / f};
  const Dual rd = dsqrt(add(mul(xd, xd), mul(yd, yd)));
  Dual ru = div(rd, add(add(dual(1.0f), mul(scale(k1, rd), rd)),
                        scale(k2, dpow(rd, 4))));
  for (int it = 0; it < kNewtonSteps; ++it) {
    const Dual f1 = sub(add(add(ru, scale(k1, dpow(ru, 3))),
                            scale(k2, dpow(ru, 5))), rd);
    const Dual f1p = add(add(dual(1.0f), mul(scale(3.0f * k1, ru), ru)),
                         scale(5.0f * k2, dpow(ru, 4)));
    ru = sub(ru, div(f1, f1p));
  }
  Dual d = add(add(dual(1.0f), mul(scale(k1, ru), ru)),
               scale(k2, dpow(ru, 4)));
  if (d.x == 0.0f) d = dual(1.0f);  // torch.where(d == 0, 1.0, d)
  // cx + f xd / d, then back to the normalized plane: (u - cx) / f
  const Dual qx = div(scale(f, xd), d), qy = div(scale(f, yd), d);
  const float h[3] = {((cx + qx.x) - cx) / f, ((cy + qy.x) - cy) / f, 1.0f};
  const float h_u[3] = {qx.du / f, qy.du / f, 0.0f};
  const float h_v[3] = {qx.dv / f, qy.dv / f, 0.0f};

  // the ray in the world frame and its angles
  const float w = __ldg(cam + 3);
  const float qv[3] = {__ldg(cam + 4), __ldg(cam + 5), __ldg(cam + 6)};
  float n[3], n_u[3], n_v[3];
  qrotate(w, qv, h, n);
  // n is linear in v: its tangents are the rotation of h's, with w
  // multiplying the cross term exactly as in the value
  qrotate(w, qv, h_u, n_u);
  qrotate(w, qv, h_v, n_v);
  const Dual nx = {n[0], n_u[0], n_v[0]}, ny = {n[1], n_u[1], n_v[1]},
             nz = {n[2], n_u[2], n_v[2]};
  const Dual theta = datan2(nx, nz);
  const Dual sn = dsqrt(add(mul(nx, nx), mul(nz, nz)));
  const Dual phi = datan2(scale(-1.0f, ny), sn);

  // d n / d q: dn/dw = t; dn/dq_k = w (2 e_k x h) + e_k x t + q_v x (2 e_k x h)
  float t[3];
  cross(qv, h, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] *= 2.0f;
  float dth[4], dph[4];
  angle_rates(n, sn.x, t, &dth[0], &dph[0]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float e[3] = {k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f,
                        k == 2 ? 1.0f : 0.0f};
    float dt[3], a[3], b[3], dn[3];
    cross(e, h, dt);
#pragma unroll
    for (int j = 0; j < 3; ++j) dt[j] *= 2.0f;
    cross(e, t, a);
    cross(qv, dt, b);
#pragma unroll
    for (int j = 0; j < 3; ++j) dn[j] = w * dt[j] + a[j] + b[j];
    angle_rates(n, sn.x, dn, &dth[k + 1], &dph[k + 1]);
  }

  float* yi = y + static_cast<size_t>(i) * kLm;
  float* jci = jc + static_cast<size_t>(i) * kLm * kCam;
  float* juvi = juv + static_cast<size_t>(i) * kLm * 2;
  float* jri = jr + static_cast<size_t>(i) * kLm;
#pragma unroll
  for (int k = 0; k < 3; ++k) yi[k] = __ldg(cam + k);
  yi[3] = theta.x;
  yi[4] = phi.x;
  yi[5] = __ldg(rho + i);
#pragma unroll
  for (int r = 0; r < kLm; ++r) {
#pragma unroll
    for (int c = 0; c < kCam; ++c) {
      float v = (r < 3 && c == r) ? 1.0f : 0.0f;
      if (r == 3 && c >= 3 && c < 7) v = dth[c - 3];
      if (r == 4 && c >= 3 && c < 7) v = dph[c - 3];
      jci[r * kCam + c] = v;
    }
    juvi[2 * r] = r == 3 ? theta.du : (r == 4 ? phi.du : 0.0f);
    juvi[2 * r + 1] = r == 3 ? theta.dv : (r == 4 ? phi.dv : 0.0f);
    jri[r] = r == 5 ? 1.0f : 0.0f;
  }
}

template <bool kEmpty>
int launch(const float* uv, const float* cam13, const float* rho, int S,
           int A, float f, float cx, float cy, float k1, float k2, float* y,
           float* jc, float* juv, float* jr, void* stream,
           int32_t* launches) {
  if (S < 1 || A < 1 || static_cast<long long>(S) * A > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (S * A + kThreads - 1) / kThreads;
  inverse_depth_init_kernel<kEmpty>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          uv, cam13, rho, S, A, f, cx, cy, k1, k2, y, jc, juv, jr, launches);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K3 over S sequences of A candidates on `stream` (layouts
// above). Returns cudaGetLastError() after the launch (0 = cudaSuccess),
// or cudaErrorInvalidValue without launching for S < 1, A < 1 or
// S * A > 2^30. `launches` ([1] int32 on the device, or null) gains one
// when the kernel runs.
extern "C" int inverse_depth_init_launch(const float* uv, const float* cam13,
                                         const float* rho, int S, int A,
                                         float f, float cx, float cy,
                                         float k1, float k2, float* y,
                                         float* jc, float* juv, float* jr,
                                         void* stream, int32_t* launches) {
  return launch<false>(uv, cam13, rho, S, A, f, cx, cy, k1, k2, y, jc, juv,
                       jr, stream, launches);
}

// An empty kernel at K3's launch configuration for S sequences of A
// candidates: the launch floor.
extern "C" int inverse_depth_init_floor_launch(int S, int A, void* stream) {
  return launch<true>(nullptr, nullptr, nullptr, S, A, 0.0f, 0.0f, 0.0f,
                      0.0f, 0.0f, nullptr, nullptr, nullptr, nullptr, stream,
                      nullptr);
}
