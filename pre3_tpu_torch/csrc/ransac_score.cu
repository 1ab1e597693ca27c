// Batched RANSAC hypothesis support scoring (kernel K1) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel pre3_tpu/ops/ransac_score.py::_score_kernel
// (wrapped there by score_hypotheses_pallas). For every hypothesis b and
// every matched point pair n:
//
//   resid2[b, n] = || R_b p2_n + t_b - p1_n ||^2
//   support[b]   = #{ n : valid_n && resid2[b, n] < thr }
//   err[b]       = sum of those inlier resid2 / max(support[b], 1)
//
// The [B, N] residual tensor lives only in registers.
//
// What bounds it on this card: at the VO shape (B = 1024 hypotheses,
// N = 256 matches) one call is ~1024·256·~20 flops and reads under 10 KB,
// so neither bandwidth nor arithmetic is the limit: launch latency and
// occupancy are. The design fills the SMs with one warp per hypothesis,
// 8 warps per block (B = 1024 → 128 blocks on 132 SMs). A block stages the
// points in shared memory as SoA floats, chunk by chunk, so any N works;
// each lane takes every 32nd point of a chunk and the lane partials are
// reduced with warp shuffles.
//
// The residual is the direct difference (pred - p1), as the plain twin
// score_hypotheses_torch computes it, not the TPU kernel's expanded form
// |pred|^2 - 2 pred.p1 + |p1|^2, which loses precision.
//
// The threshold is read from device memory: on the main path it is a
// device scalar (vo/ransac.py), and passing it by value would cost one
// host sync per frame pair.
//
// Plain C interface, loaded with ctypes (pre3_tpu_torch/utils/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;  // points staged in shared memory per pass

// (r0·x + r1·y + r2·z + t) − p, rounded step by step in this order. The
// _rn intrinsics are never contracted into fused multiply-adds, so the
// residual is bitwise the one score_hypotheses_torch computes.
__device__ __forceinline__ float component(float r0, float r1, float r2,
                                           float t, float x, float y,
                                           float z, float p) {
  const float pred = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r0, x), __fmul_rn(r1, y)),
                __fmul_rn(r2, z)),
      t);
  return __fsub_rn(pred, p);
}

__global__ void __launch_bounds__(kThreads)
ransac_score_kernel(const float* __restrict__ r,      // [B, 3, 3]
                    const float* __restrict__ t,      // [B, 3]
                    const float* __restrict__ p1,     // [N, 3]
                    const float* __restrict__ p2,     // [N, 3]
                    const uint8_t* __restrict__ valid,  // [N] (torch.bool)
                    const float* __restrict__ thr_ptr,  // [] squared gate
                    int B, int N,
                    int32_t* __restrict__ support,    // [B]
                    float* __restrict__ err) {        // [B]
  __shared__ float s_p1[3][kChunk];
  __shared__ float s_p2[3][kChunk];
  __shared__ uint8_t s_valid[kChunk];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  const bool active = b < B;
  // A warp past the ragged end still takes part in the block's staging
  // and barriers; it scores hypothesis 0 and stores nothing.
  const int hb = active ? b : 0;

  float R[9], T[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = __ldg(r + hb * 9 + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) T[k] = __ldg(t + hb * 3 + k);
  const float thr = __ldg(thr_ptr);

  int count = 0;
  float sum = 0.0f;
  for (int base = 0; base < N; base += kChunk) {
    const int n_chunk = min(kChunk, N - base);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < 3 * n_chunk; i += kThreads) {
      const int n = i / 3, c = i - 3 * n;
      s_p1[c][n] = __ldg(p1 + 3 * base + i);
      s_p2[c][n] = __ldg(p2 + 3 * base + i);
    }
    for (int i = threadIdx.x; i < n_chunk; i += kThreads) {
      s_valid[i] = __ldg(valid + base + i);
    }
    __syncthreads();
    for (int n = lane; n < n_chunk; n += 32) {
      const float x = s_p2[0][n], y = s_p2[1][n], z = s_p2[2][n];
      const float dx = component(R[0], R[1], R[2], T[0], x, y, z, s_p1[0][n]);
      const float dy = component(R[3], R[4], R[5], T[1], x, y, z, s_p1[1][n]);
      const float dz = component(R[6], R[7], R[8], T[2], x, y, z, s_p1[2][n]);
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (s_valid[n] && r2 < thr) {
        ++count;
        sum += r2;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off);
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (active && lane == 0) {
    support[b] = count;
    err[b] = sum / static_cast<float>(max(count, 1));
  }
}

}  // namespace

// Launches K1 on `stream`. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess). B must be >= 1; N may be 0.
extern "C" int ransac_score_launch(const float* r, const float* t,
                                   const float* p1, const float* p2,
                                   const uint8_t* valid, const float* thr,
                                   int B, int N, int32_t* support, float* err,
                                   void* stream) {
  const dim3 grid((B + kWarps - 1) / kWarps);
  ransac_score_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      r, t, p1, p2, valid, thr, B, N, support, err);
  return static_cast<int>(cudaGetLastError());
}
