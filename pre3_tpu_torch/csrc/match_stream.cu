// Streaming best/second descriptor matcher (kernel K2) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel pre3_tpu/ops/matching.py::_match_kernel
// (wrapped there by match_descriptors_pallas). For every row i of
// d1 [N1, D] against d2 [N2, D]:
//
//   dist2[i, j] = max(|d1_i|^2 + |d2_j|^2 - 2 d1_i.d2_j, 0)   (valid j)
//               = 1e30                                      (invalid j)
//   best[i]   = min_j dist2[i, j],  idx[i] = lowest j attaining it
//   second[i] = the runner-up, equal to best when two columns tie
//
// The [N1, N2] distance matrix never reaches device memory: each thread
// keeps a running (best, second, idx) for its rows over its columns.
//
// What bounds it on this card: at the EKF step's shape (256 x 256, D = 121)
// the whole call is ~8 MFMA and 250 KB of reads, so launch latency is the
// limit, and the point of K2 is that it is ONE launch where the plain
// version is a dozen (norms, matmul, add, clamp, where, amin, argmin,
// scatter, amin). At map scale (8192^2, D = 128, 8.6 GFMA) it is bound by
// f32 FMA issue and shared-memory loads: no tensor cores, because the
// port keeps TF32 off.
//
// Design: a block owns BM = 32 rows of d1, held in shared memory for the
// whole call (D <= 256). Tiles of BN = 64 columns of d2 stream through
// shared memory, KC = 32 dimensions at a time. 256 threads form a 16 x 16
// grid; thread (ty, tx) accumulates the 2 x 4 dot products of rows
// ty + 16r and columns tx + 16c in registers, so each k step costs 6
// shared loads (broadcast or conflict-free: both tiles are stored k-major
// with an odd row pitch) for 8 FMAs. Every thread visits its columns in
// ascending order and replaces its best only on a strict '<', so it keeps
// the lowest index among equal distances; the 16 threads sharing a row
// merge with __shfl_xor_sync under the reference's rule
// (pre3_tpu/ops/matching.py:131-135) plus an explicit lower-index tie
// break, which is argmin's.
//
// An invalid column enters as exactly 1e30f (as the plain version's
// torch.where does), not through the reference's +BIG norm trick. A row
// with no valid column ends with best = second = 1e30 and idx = 0.
//
// Plain C interface, loaded with ctypes (pre3_tpu_torch/utils/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 16;
constexpr int kTy = 16;
constexpr int kThreads = kTx * kTy;
constexpr int kTM = 2;  // rows per thread
constexpr int kTN = 4;  // columns per thread per tile
constexpr int kBM = kTy * kTM;  // 32 rows of d1 per block
constexpr int kBN = kTx * kTN;  // 64 columns of d2 per tile
constexpr int kKC = 32;  // dimensions of a d2 tile staged per pass
constexpr int kMaxD = 256;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Fold (b2, s2, i2) into (b, s, i): the lower distance wins, equal
// distances keep the lower index, and the runner-up is the smaller of the
// loser's best and both runners-up (a tie makes it equal to best).
__device__ __forceinline__ void merge(float& b, float& s, int& i, float b2,
                                      float s2, int i2) {
  const float ns = fminf(fmaxf(b, b2), fminf(s, s2));
  if (b2 < b || (b2 == b && i2 < i)) i = i2;
  b = fminf(b, b2);
  s = ns;
}

__global__ void __launch_bounds__(kThreads)
match_stream_kernel(const float* __restrict__ d1,       // [N1, D]
                    const float* __restrict__ d2,       // [N2, D]
                    const uint8_t* __restrict__ valid2, // [N2] or null
                    int N1, int N2, int D,
                    int64_t* __restrict__ out_idx,      // [N1]
                    float* __restrict__ out_best,       // [N1]
                    float* __restrict__ out_second) {   // [N1]
  __shared__ float sA[kMaxD][kBM + 1];
  __shared__ float sB[kKC][kBN + 1];
  __shared__ float sN1[kBM];
  __shared__ float sN2[kBN];
  __shared__ uint8_t sV[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM;

  // The block's d1 rows, k-major, and their squared norms.
  for (int e = tid; e < kBM * D; e += kThreads) {
    const int r = e / D, k = e - r * D;
    const int m = m0 + r;
    sA[k][r] = m < N1 ? __ldg(d1 + static_cast<size_t>(m) * D + k) : 0.0f;
  }
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int m = m0 + r;
    float s = 0.0f;
    if (m < N1) {
      for (int k = lane; k < D; k += 32) {
        const float v = __ldg(d1 + static_cast<size_t>(m) * D + k);
        s = fmaf(v, v, s);
      }
    }
    s = warp_sum(s);
    if (lane == 0) sN1[r] = s;
  }

  float best[kTM], second[kTM];
  int idx[kTM];
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    best[r] = kBig;
    second[r] = kBig;
    idx[r] = 0;
  }

  for (int n0 = 0; n0 < N2; n0 += kBN) {
    __syncthreads();  // the previous tile's norms and flags are consumed
    for (int c = warp; c < kBN; c += kThreads / 32) {
      const int n = n0 + c;
      float s = 0.0f;
      if (n < N2) {
        for (int k = lane; k < D; k += 32) {
          const float v = __ldg(d2 + static_cast<size_t>(n) * D + k);
          s = fmaf(v, v, s);
        }
      }
      s = warp_sum(s);
      if (lane == 0) {
        sN2[c] = s;
        sV[c] = n < N2 && (valid2 == nullptr || valid2[n]);
      }
    }

    float acc[kTM][kTN];
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[r][c] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += kKC) {
      const int kc = min(kKC, D - k0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = tid; e < kBN * kKC; e += kThreads) {
        const int c = e / kKC, kk = e - c * kKC;
        const int n = n0 + c;
        sB[kk][c] = (n < N2 && kk < kc)
                        ? __ldg(d2 + static_cast<size_t>(n) * D + k0 + kk)
                        : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        float a[kTM], b[kTN];
#pragma unroll
        for (int r = 0; r < kTM; ++r) a[r] = sA[k0 + kk][ty + kTy * r];
#pragma unroll
        for (int c = 0; c < kTN; ++c) b[c] = sB[kk][tx + kTx * c];
#pragma unroll
        for (int r = 0; r < kTM; ++r)
#pragma unroll
          for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }

    // This tile's distances into the running state, columns ascending.
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int cl = tx + kTx * c;
      const int n = n0 + cl;
      if (n >= N2) break;
      const bool ok = sV[cl] != 0;
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        const float d = ok ? fmaxf(sN1[ty + kTy * r] + sN2[cl] - 2.0f * acc[r][c], 0.0f)
                           : kBig;
        if (d < best[r]) {
          second[r] = best[r];
          best[r] = d;
          idx[r] = n;
        } else if (d < second[r]) {
          second[r] = d;
        }
      }
    }
  }

  // Merge the 16 threads (lanes differing in their low 4 bits) of each row.
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
      const float b2 = __shfl_xor_sync(0xffffffffu, best[r], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, second[r], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx[r], off);
      merge(best[r], second[r], idx[r], b2, s2, i2);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
      const int m = m0 + ty + kTy * r;
      if (m < N1) {
        out_idx[m] = idx[r];
        out_best[m] = best[r];
        out_second[m] = second[r];
      }
    }
  }
}

}  // namespace

// Launches K2 on `stream`. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess), or cudaErrorInvalidValue without launching when a
// size is out of range (N1, N2 >= 1, 1 <= D <= 256). `valid2` may be null
// (every column valid).
extern "C" int match_stream_launch(const float* d1, const float* d2,
                                   const uint8_t* valid2, int N1, int N2,
                                   int D, int64_t* idx, float* best,
                                   float* second, void* stream) {
  if (N1 < 1 || N2 < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N1 + kBM - 1) / kBM);
  match_stream_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d1, d2, valid2, N1, N2, D, idx, best, second);
  return static_cast<int>(cudaGetLastError());
}
