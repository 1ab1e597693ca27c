// The IFT covariance of the VO increment (kernel K4) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this inside the jitted
// step (pre3_tpu/vo/covariance.py::vo_covariance, a hessian and two
// jacfwd-of-grad passes over the matched points). The port's plain version
// (vo/covariance.py::vo_covariance_torch) runs the same passes, ~800 tiny
// kernels in every captured step graph; this kernel computes the same
// derivatives from their closed form (ops/vo_covariance.py's docstring) in
// one launch. For each sequence s, from the fit (R [3, 3], t [3]) and the
// N point pairs (p1, p2) with weights w, at q_i = R p2_i, e_i = p1_i - q_i
// - t:
//
//   A   = sum_i w_i J_i^T J_i, J_i = [I, -[q_i]x], its omega block less
//         sum_i w_i (1/2 (e_i q_i^T + q_i e_i^T) - (e_i . q_i) I)
//   mid = sum_i w_i^2 (U_i S(p1_i) U_i^T + V_i S(p2_i) V_i^T),
//         U_i = [I; [q_i]x], V_i = [I; [p1_i - t]x] R
//   cov = sym((A + damping I)^-1 mid (A + damping I)^-T)
//
// with S the SR4000 point covariance var_r rr^T + (r sigma_ang)^2 (I - rr^T)
// along the unit ray r of the point.
//
// What bounds it on this card: ~8 KB of input and 144 bytes of output per
// sequence, ~700 flops per point: nothing but the launch and the block's
// chains of dependent f64 operations, reductions and the 6x6 inverse. One
// block per sequence, 320 threads striding over the points: each thread sums its points' 10
// sufficient entries of A (sum w, sum w q, the omega block's upper 6) and
// the 21 upper entries of mid in registers; warp shuffles, then shared
// memory across the 10 warps, in a fixed order, so a replayed graph gives
// the same bits every time. One warp then inverts the damped A by
// Gauss-Jordan with partial pivoting (the first row of largest |pivot|,
// as LAPACK's LU picks it; with all weights 0 the inverse is 1/damping I
// and cov is 0) and forms (A^-1 mid) A^-T and its symmetric part. No
// atomics but the launch counter.
//
// Precision: the inputs and the result are f32; everything between is
// f64. With few or nearly collinear inliers A is ill-conditioned: an f32
// A inverted there, or an f32 mid projected on A's weak direction, lands
// up to ~3e-4 of max |cov| from the f64 value of the same f32 inputs (the
// plain f32 torch.func version does too), where f64 stays within ~1e-7.
// The ~200 kflop of a step cost the f64 units well under a microsecond.
// No matrix product on the tensor cores, so TF32 cannot enter.
//
// Layouts (contiguous, float32): r [S, 3, 3], t [S, 3], p1 [S, N, 3],
// p2 [S, N, 3], w [S, N] -> cov [S, 6, 6]. A single problem is S = 1.
//
// Plain C interface, loaded with ctypes (pre3_tpu_torch/utils/cuda_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// one point per thread up to N = 320 (the step's 256 or 288); ~170
// registers a thread fit 320 threads in the SM's 65,536
constexpr int kThreads = 320;
constexpr int kWarps = kThreads / 32;
constexpr int kA = 10;    // sum w, sum w q (3), the omega block's upper 6
constexpr int kMid = 21;  // mid's upper triangle
constexpr int kSums = kA + kMid;

// Row-major upper-triangle index of (a, b), a <= b, in an n x n matrix.
__host__ __device__ constexpr int upper(int n, int a, int b) {
  return a * n - a * (a - 1) / 2 + (b - a);
}

// The SR4000 covariance of point p, its upper triangle
// (xx, xy, xz, yy, yz, zz): vo/covariance.py::sr4000_point_covariance.
__device__ __forceinline__ void point_cov(const double p[3], double var_r,
                                          double sigma_ang, double s[6]) {
  const double r = sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
  const double inv = 1.0 / fmax(r, 1e-9);
  const double ray[3] = {p[0] * inv, p[1] * inv, p[2] * inv};
  const double st = r * sigma_ang;
  const double var_t = st * st;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = a; b < 3; ++b) {
      const double rr = ray[a] * ray[b];
      s[upper(3, a, b)] = var_r * rr + var_t * ((a == b ? 1.0 : 0.0) - rr);
    }
  }
}

// Adds w2 * (U S U^T)'s upper triangle to mid, U [6, 3] row-major.
__device__ __forceinline__ void add_sandwich(const double u[6][3],
                                             const double s6[6], double w2,
                                             double* mid) {
  double s[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) s[a][b] = s6[a <= b ? upper(3, a, b)
                                                     : upper(3, b, a)];
  }
  double us[6][3];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      us[a][k] = u[a][0] * s[0][k] + u[a][1] * s[1][k] + u[a][2] * s[2][k];
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) {
      mid[upper(6, a, b)] += w2 * (us[a][0] * u[b][0] + us[a][1] * u[b][1] +
                                   us[a][2] * u[b][2]);
    }
  }
}

// Entry (i, j) of the damped A from the block's sums.
__device__ __forceinline__ double a_entry(const double* tot, int i, int j,
                                          double damping) {
  double v;
  if (i < 3 && j < 3) {
    v = i == j ? tot[0] : 0.0;
  } else if (i >= 3 && j >= 3) {
    const int a = min(i, j) - 3, b = max(i, j) - 3;
    v = tot[4 + upper(3, a, b)];
  } else {
    // the dt-omega block -[sum w q]x and its transpose [sum w q]x
    const int row = i < 3 ? i : j, col = i < 3 ? j - 3 : i - 3;
    const double* sq = tot + 1;
    const double cross[3][3] = {{0.0, -sq[2], sq[1]},
                                {sq[2], 0.0, -sq[0]},
                                {-sq[1], sq[0], 0.0}};
    v = -cross[row][col];
  }
  return i == j ? v + damping : v;
}

template <bool kEmpty>
__global__ void __launch_bounds__(kThreads)
vo_covariance_kernel(const float* __restrict__ r,   // [S, 3, 3]
                     const float* __restrict__ t,   // [S, 3]
                     const float* __restrict__ p1,  // [S, N, 3]
                     const float* __restrict__ p2,  // [S, N, 3]
                     const float* __restrict__ w,   // [S, N]
                     int N, double var_r, double sigma_ang, double damping,
                     float* __restrict__ cov,  // [S, 6, 6]
                     int32_t* __restrict__ launches) {  // [1] or null
  if constexpr (kEmpty) return;
  // the launch counter: one per launch, where the kernel runs (a replayed
  // CUDA graph counts too)
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(launches, 1);
  }
  const int seq = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double rot[3][3], tr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    tr[a] = __ldg(t + 3 * seq + a);
#pragma unroll
    for (int b = 0; b < 3; ++b) rot[a][b] = __ldg(r + 9 * seq + 3 * a + b);
  }

  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  const size_t base = static_cast<size_t>(seq) * N;
  for (int i = tid; i < N; i += kThreads) {
    const float* a1 = p1 + 3 * (base + i);
    const float* a2 = p2 + 3 * (base + i);
    const double x1[3] = {__ldg(a1), __ldg(a1 + 1), __ldg(a1 + 2)};
    const double x2[3] = {__ldg(a2), __ldg(a2 + 1), __ldg(a2 + 2)};
    const double wi = __ldg(w + base + i);
    double q[3], e[3], c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      q[a] = rot[a][0] * x2[0] + rot[a][1] * x2[1] + rot[a][2] * x2[2];
      e[a] = x1[a] - q[a] - tr[a];
      c[a] = x1[a] - tr[a];
    }
    // A: sum w, sum w q, and the omega block
    // w ((|q|^2 + e.q) I - q q^T - 1/2 (e q^T + q e^T))
    const double qq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2];
    const double eq = e[0] * q[0] + e[1] * q[1] + e[2] * q[2];
    acc[0] += wi;
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[1 + a] += wi * q[a];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = a; b < 3; ++b) {
        const double v = (a == b ? qq + eq : 0.0) - q[a] * q[b] -
                         0.5 * (e[a] * q[b] + q[a] * e[b]);
        acc[4 + upper(3, a, b)] += wi * v;
      }
    }
    // mid: U = [I; [q]x] against S(p1), V = [I; [p1 - t]x] R against S(p2)
    double s[6];
    double u[6][3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0},
                      {0.0, -q[2], q[1]}, {q[2], 0.0, -q[0]},
                      {-q[1], q[0], 0.0}};
    const double w2 = wi * wi;
    point_cov(x1, var_r, sigma_ang, s);
    add_sandwich(u, s, w2, acc + kA);
    const double cx[3][3] = {{0.0, -c[2], c[1]},
                             {c[2], 0.0, -c[0]},
                             {-c[1], c[0], 0.0}};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        u[a][b] = rot[a][b];
        u[3 + a][b] = cx[a][0] * rot[0][b] + cx[a][1] * rot[1][b] +
                      cx[a][2] * rot[2][b];
      }
    }
    point_cov(x2, var_r, sigma_ang, s);
    add_sandwich(u, s, w2, acc + kA);
  }

  // block sums: a warp's by shuffles, then the warps' in order
  __shared__ double part[kWarps][kSums];
  __shared__ double tot[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    double v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (tid < kSums) {
    double v = part[0][tid];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += part[k][tid];
    tot[tid] = v;
  }
  __syncthreads();
  if (warp != 0) return;

  // one warp: [A + damping I | I] by Gauss-Jordan with partial pivoting
  __shared__ double m[6][12];
  __shared__ double mid[6][6];
  __shared__ double prod[6][6];
  for (int k = lane; k < 72; k += 32) {
    const int i = k / 12, j = k % 12;
    m[i][j] = j < 6 ? a_entry(tot, i, j, damping)
                    : (j - 6 == i ? 1.0 : 0.0);
  }
  for (int k = lane; k < 36; k += 32) {
    const int i = k / 6, j = k % 6;
    mid[i][j] = tot[kA + upper(6, min(i, j), max(i, j))];
  }
  __syncwarp();
  for (int k = 0; k < 6; ++k) {
    int p = k;
    double best = fabs(m[k][k]);
    for (int i = k + 1; i < 6; ++i) {
      const double v = fabs(m[i][k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
    __syncwarp();  // every lane has read column k before the swap
    if (p != k && lane < 12) {
      const double x = m[k][lane];
      m[k][lane] = m[p][lane];
      m[p][lane] = x;
    }
    __syncwarp();
    const double inv = 1.0 / m[k][k];
    double f[3], rk[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int e = lane + 32 * s;
      if (e < 72) {
        f[s] = m[e / 12][k];
        rk[s] = m[k][e % 12] * inv;
      }
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int e = lane + 32 * s;
      if (e < 72) {
        const int i = e / 12, j = e % 12;
        m[i][j] = i == k ? rk[s] : m[i][j] - f[s] * rk[s];
      }
    }
    __syncwarp();
  }
  // (A^-1 mid) A^-T, then its symmetric part
  for (int k = lane; k < 36; k += 32) {
    const int i = k / 6, j = k % 6;
    double v = 0.0;
#pragma unroll
    for (int l = 0; l < 6; ++l) v += m[i][6 + l] * mid[l][j];
    prod[i][j] = v;
  }
  __syncwarp();
  for (int k = lane; k < 36; k += 32) {
    const int i = k / 6, j = k % 6;
    double v = 0.0;
#pragma unroll
    for (int l = 0; l < 6; ++l) v += prod[i][l] * m[j][6 + l];
    mid[i][j] = v;
  }
  __syncwarp();
  float* out = cov + 36 * static_cast<size_t>(seq);
  for (int k = lane; k < 36; k += 32) {
    const int i = k / 6, j = k % 6;
    out[k] = static_cast<float>(0.5 * (mid[i][j] + mid[j][i]));
  }
}

template <bool kEmpty>
int launch(const float* r, const float* t, const float* p1, const float* p2,
           const float* w, int S, int N, double var_r, double sigma_ang,
           double damping, float* cov, void* stream, int32_t* launches) {
  if (S < 1 || N < 0 || static_cast<long long>(S) * N > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vo_covariance_kernel<kEmpty>
      <<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          r, t, p1, p2, w, N, var_r, sigma_ang, damping, cov, launches);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K4 over S sequences of N point pairs on `stream` (layouts
// above); var_r is the range variance, sigma_ang the angular sigma (rad),
// damping the ridge on A. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess), or cudaErrorInvalidValue without launching for S < 1,
// N < 0 or S * N > 2^30. `launches` ([1] int32 on the device, or null)
// gains one when the kernel runs.
extern "C" int vo_covariance_launch(const float* r, const float* t,
                                    const float* p1, const float* p2,
                                    const float* w, int S, int N,
                                    double var_r, double sigma_ang,
                                    double damping, float* cov, void* stream,
                                    int32_t* launches) {
  return launch<false>(r, t, p1, p2, w, S, N, var_r, sigma_ang, damping, cov,
                       stream, launches);
}

// An empty kernel at K4's launch configuration for S sequences: the launch
// floor.
extern "C" int vo_covariance_floor_launch(int S, void* stream) {
  return launch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, S, 0, 0.0,
                      0.0, 0.0, nullptr, stream, nullptr);
}
