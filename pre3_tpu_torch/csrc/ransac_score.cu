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
// A batched launch scores S independent problems at once (the sequence
// axis of run_slam_batched): r [S, B, 3, 3], t [S, B, 3], p1/p2 [S, N, 3],
// valid [S, N], thr [S] -> support/err [S, B]. blockIdx.y is the
// sequence; a block offsets its pointers to that sequence and then runs
// the single launch's code, so each sequence's rows are bitwise those of
// a single launch on its inputs. A single problem is a launch at S = 1.
//
// What bounds it on this card: at the path's shapes (B = 512 or 1024
// hypotheses, N = 256 matches) one call is ~28 flops x B x N (3.7 MFLOP at
// 512: 0.055 us at the 67 TFLOP/s f32 rate) and reads under 40 KB, so
// neither bandwidth nor arithmetic is the limit: launch latency and the
// chain of dependent loads in each block are. The design therefore fills
// the SMs with short blocks: one warp per hypothesis and 4 warps per
// block, so B = 512 gives 128 blocks on 132 SMs and B = 1024 gives 256.
// (Two warps per hypothesis, 256 and 512 blocks, timed the same at
// B = 512 and slower at B = 1024.)
// A block stages the points in shared memory chunk by chunk (any N works)
// as flat [3 n] arrays, with 16-byte loads where they are aligned and all
// of a thread's loads in flight at once: no i / 3 per element, one round
// trip to memory per chunk, and the strided reads (3 n) hit distinct
// banks.
// Each lane takes every 32nd point; the lane partials are reduced with
// warp shuffles.
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

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;  // points staged in shared memory per pass

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

// One chunk of n <= kChunk points into shared memory: p1 and p2 as flat
// [3 n] arrays, the flags as bytes. Every thread issues all its loads
// before it stores any, so the chunk costs one round trip to memory; the
// points move 16 bytes at a time where both arrays are 16-byte aligned
// (the chunk offset 3 * kChunk floats keeps that).
__device__ __forceinline__ void stage(float* __restrict__ s1,
                                      float* __restrict__ s2,
                                      uint8_t* __restrict__ sv,
                                      const float* __restrict__ p1,
                                      const float* __restrict__ p2,
                                      const uint8_t* __restrict__ valid,
                                      int n) {
  constexpr int kVec = 3 * kChunk / 4 / kThreads;  // float4s per thread
  constexpr int kFlags = kChunk / kThreads;        // flags per thread
  const int tid = threadIdx.x;
  const int nf = 3 * n;
  uint8_t v[kFlags];
#pragma unroll
  for (int j = 0; j < kFlags; ++j) {
    const int i = tid + j * kThreads;
    v[j] = i < n ? __ldg(valid + i) : 0;
  }
  if (((reinterpret_cast<uintptr_t>(p1) | reinterpret_cast<uintptr_t>(p2)) & 15) == 0) {
    const int nv = nf / 4;
    const float4* a4 = reinterpret_cast<const float4*>(p1);
    const float4* b4 = reinterpret_cast<const float4*>(p2);
    float4 a[kVec], b[kVec];
    float ta = 0.0f, tb = 0.0f;  // the tail past the last whole float4
    const int tail = 4 * nv + tid;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = tid + j * kThreads;
      if (i < nv) {
        a[j] = __ldg(a4 + i);
        b[j] = __ldg(b4 + i);
      }
    }
    if (tid < nf - 4 * nv) {
      ta = __ldg(p1 + tail);
      tb = __ldg(p2 + tail);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = tid + j * kThreads;
      if (i < nv) {
        reinterpret_cast<float4*>(s1)[i] = a[j];
        reinterpret_cast<float4*>(s2)[i] = b[j];
      }
    }
    if (tid < nf - 4 * nv) {
      s1[tail] = ta;
      s2[tail] = tb;
    }
  } else {
    constexpr int kScalar = 3 * kChunk / kThreads;
    float a[kScalar], b[kScalar];
#pragma unroll
    for (int j = 0; j < kScalar; ++j) {
      const int i = tid + j * kThreads;
      if (i < nf) {
        a[j] = __ldg(p1 + i);
        b[j] = __ldg(p2 + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kScalar; ++j) {
      const int i = tid + j * kThreads;
      if (i < nf) {
        s1[i] = a[j];
        s2[i] = b[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kFlags; ++j) {
    const int i = tid + j * kThreads;
    if (i < n) sv[i] = v[j];
  }
}

// kEmpty: an empty kernel at the same launch configuration, the floor no
// K1 launch can go below (timed by chip_smoke.py).
template <bool kEmpty>
__global__ void __launch_bounds__(kThreads)
ransac_score_kernel(const float* __restrict__ r,      // [S, B, 3, 3]
                    const float* __restrict__ t,      // [S, B, 3]
                    const float* __restrict__ p1,     // [S, N, 3]
                    const float* __restrict__ p2,     // [S, N, 3]
                    const uint8_t* __restrict__ valid,  // [S, N] (torch.bool)
                    const float* __restrict__ thr_ptr,  // [S] squared gates
                    int B, int N,
                    int32_t* __restrict__ support,    // [S, B]
                    float* __restrict__ err,          // [S, B]
                    int32_t* __restrict__ launches) { // [1] or null
  if constexpr (kEmpty) return;
  // the launch counter: one per launch, where the kernel runs (a replayed
  // CUDA graph counts too)
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0) {
    atomicAdd(launches, 1);
  }
  {  // this block's sequence
    const size_t s = blockIdx.y;
    r += s * B * 9;
    t += s * B * 3;
    p1 += s * N * 3;
    p2 += s * N * 3;
    valid += s * N;
    thr_ptr += s;
    support += s * B;
    err += s * B;
  }
  __shared__ __align__(16) float s_p1[3 * kChunk];
  __shared__ __align__(16) float s_p2[3 * kChunk];
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
    if (base > 0) __syncthreads();  // the previous chunk is consumed
    stage(s_p1, s_p2, s_valid, p1 + 3 * base, p2 + 3 * base, valid + base,
          n_chunk);
    __syncthreads();
    for (int n = lane; n < n_chunk; n += 32) {
      const float x = s_p2[3 * n], y = s_p2[3 * n + 1], z = s_p2[3 * n + 2];
      const float dx = component(R[0], R[1], R[2], T[0], x, y, z, s_p1[3 * n]);
      const float dy = component(R[3], R[4], R[5], T[1], x, y, z, s_p1[3 * n + 1]);
      const float dz = component(R[6], R[7], R[8], T[2], x, y, z, s_p1[3 * n + 2]);
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

template <bool kEmpty>
int launch(const float* r, const float* t, const float* p1, const float* p2,
           const uint8_t* valid, const float* thr, int S, int B, int N,
           int32_t* support, float* err, void* stream, int32_t* launches) {
  if (S < 1 || S > 65535 || B < 1 || N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((B + kWarps - 1) / kWarps, S);
  ransac_score_kernel<kEmpty>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          r, t, p1, p2, valid, thr, B, N, support, err, launches);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 over S sequences on `stream` (layouts above; a single
// problem is S = 1). Returns cudaGetLastError() after the launch
// (0 = cudaSuccess), or cudaErrorInvalidValue without launching for
// S < 1, S > 65535, B < 1 or N < 0. `launches` ([1] int32 on the device,
// or null) gains one when the kernel runs.
extern "C" int ransac_score_launch(const float* r, const float* t,
                                   const float* p1, const float* p2,
                                   const uint8_t* valid, const float* thr,
                                   int S, int B, int N, int32_t* support,
                                   float* err, void* stream,
                                   int32_t* launches) {
  return launch<false>(r, t, p1, p2, valid, thr, S, B, N, support, err,
                       stream, launches);
}

// An empty kernel at K1's launch configuration for S sequences of B
// hypotheses: the launch floor.
extern "C" int ransac_score_floor_launch(int S, int B, void* stream) {
  return launch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, S,
                      B, 0, nullptr, nullptr, stream, nullptr);
}
