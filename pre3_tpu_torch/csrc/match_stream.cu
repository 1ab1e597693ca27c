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
// The [N1, N2] distance matrix never reaches device memory.
//
// What bounds it on this card: the product d1.d2^T. At map scale (8192^2,
// D = 128) that is 17 GFLOP, which the TF32 tensor cores (495 TFLOP/s)
// would run in 35 us; the bytes (8 MB) take 2.5 us. The warp-level
// mma.sync used here peaks at 319 TFLOP/s in TF32 on the H100
// (utils/mma_probe.py), so 3xTF32 gives at most ~106 TFLOP/s of f32
// work. At the EKF step's shape (256 x 256, D = 121) the whole call is
// 16 MFLOP and 250 KB, so it is bound by launch and memory latency, and
// what counts is how many SMs share the work and how short each block's
// chain of dependent steps is.
//
// Design:
//  * A thread-block cluster of kRanks = 8 blocks (the portable limit)
//    shares one tile of kBM d1 rows; rank s walks the columns
//    [s*N2/8, (s+1)*N2/8) of d2. The grid is 8 x ceil(N1 / kBM) blocks of
//    8 warps: kBM = 32 at 256 x 256 (64 blocks), kBM = 64 once that
//    gives two blocks per SM (N1 >= 2112). The ranks' per-row partials
//    are merged by rank 0 through distributed shared memory after
//    cluster.sync(): no global scratch, no atomics, nothing to reset, so
//    a launch is safe under graph capture and on any stream.
//  * The block's d1 rows are staged once; d2 streams through two
//    64-column tiles in shared memory with cp.async, the next tile
//    loading while the current one runs through the tensor cores, with
//    one barrier per tile. Rows of D % 4 != 0 floats (D = 121: 484
//    bytes) are not 16-byte aligned, so they are copied 4 bytes at a
//    time; D % 4 == 0 copies 16 bytes. Dimensions are zero-padded up to a
//    multiple of 32 in shared memory only. The row pitch is that multiple
//    + 4 floats, so the 16-byte fragment reads below are conflict-free.
//  * A warp computes 16 rows x 16 (kBM = 32) or 32 (kBM = 64) columns of
//    a tile on the tensor cores in 3xTF32 (mma.sync m16n8k8): each
//    operand is split as hi = tf32(x), lo = x - hi, and lo.hi + hi.lo +
//    hi.hi accumulates in f32. That keeps f32-level agreement with the
//    plain matcher (the port keeps TF32 off); a single TF32 pass would put
//    dist2 ~3e-4 off. The tensor cores truncate as they accumulate, so a
//    long chain of MMAs into one accumulator drifts: the small terms take
//    their own accumulator, and hi.hi is summed over 32 dimensions at a
//    time and then added in f32. The d2 norms accumulate in f32 from the
//    same fragment loads; the d1 norms once per block; the n1 + n2 - 2g
//    epilogue is plain f32.
//  * Each thread folds its accumulator columns in ascending order into a
//    running (best, second, idx) per row, replacing best only on a strict
//    '<'. The four threads of a row merge by __shfl_xor_sync, the column
//    warps of a row through shared memory, the 8 ranks through
//    distributed shared memory, all with merge(): the lower distance
//    wins, equal distances keep the lower index (argmin's rule), and the
//    runner-up is min(max(b1, b2), s1, s2), so duplicate columns give
//    second == best. A rank with no column reports (1e30, 1e30, 0).
//
// A batched launch matches S independent problems at once (the sequence
// axis of run_slam_batched): d1 [S, N1, D], d2 [S, N2, D], valid2 [S, N2]
// -> [S, N1]. blockIdx.y is the sequence, an axis the cluster (8 x 1 x 1)
// does not span, so every cluster lies inside one sequence; a block
// offsets its pointers to that sequence and runs the single launch's
// code, with the tile size the single launch would pick for N1. Each
// sequence's rows are therefore bitwise those of a single launch on its
// inputs, ties and the rank-order merge included. A single problem is a
// launch at S = 1.
//
// An invalid column enters as exactly 1e30f (as the plain version's
// torch.where does), not through the reference's +BIG norm trick. A row
// with no valid column ends with best = second = 1e30 and idx = 0.
//
// Plain C interface, loaded with ctypes (pre3_tpu_torch/utils/cuda_build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 64;        // d2 columns per tile
constexpr int kKC = 32;        // dimensions per hi.hi partial sum
constexpr int kRanks = 8;      // blocks per cluster, each a range of columns
constexpr int kMaxD = 256;
constexpr int kWaveBlocks = 2 * 132;  // two blocks on each of the H100's SMs
constexpr float kBig = 1e30f;

__host__ __device__ constexpr int padded(int d) { return (d + kKC - 1) / kKC * kKC; }
__host__ __device__ constexpr int pitch_of(int d) { return padded(d) + 4; }

template <int kBM>
constexpr size_t smem_bytes(int d) {
  return sizeof(float) * static_cast<size_t>(kBM + 2 * kBN) * pitch_of(d);
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

// Column n at distance d, visited in ascending n: a strict '<' replaces
// the best, else the runner-up takes the smaller (selects, no branch).
__device__ __forceinline__ void fold(float& b, float& s, int& i, float d,
                                     int n) {
  const bool lt = d < b;
  s = lt ? b : fminf(s, d);
  i = lt ? n : i;
  b = lt ? d : b;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + rows) of src [*, D] into dst [rows][P]; rows at or
// past `end` are zero-filled (the copy reads nothing for them).
template <int kWarps>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int end, int rows, int D,
                                           int P, bool vec16) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    const bool ok = row0 + r < end;
    const float* s = src + static_cast<size_t>(ok ? row0 + r : 0) * D;
    float* d = dst + r * P;
    if (vec16) {
      for (int c = 4 * lane; c < D; c += 128) cp_async16(d + c, s + c, ok);
    } else {
      for (int c = lane; c < D; c += 32) cp_async4(d + c, s + c, ok);
    }
  }
}

// x = hi + lo, the 3xTF32 operands: hi is x rounded to tf32's 10
// mantissa bits, to nearest with ties away from zero (cvt.rna's rounding,
// done in the integer pipe: the conversion pipe is a fraction of its
// rate); lo = x - hi is exact and goes in whole, the tensor core reading
// its top 19 bits (|lo| <= 2^-11 |x|, so what it drops is <= 2^-22 |x|).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a.b on a 16 x 8 x 8 tile (TF32 inputs, f32 accumulators).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kEmpty: an empty kernel at the same launch configuration, the floor no
// K2 launch of this shape can go below (timed by chip_smoke.py).
template <int kBM, int kWarpsN, bool kEmpty>
__global__ void __launch_bounds__(32 * kBM / 16 * kWarpsN, 2)
match_stream_kernel(const float* __restrict__ d1,       // [S, N1, D]
                    const float* __restrict__ d2,       // [S, N2, D]
                    const uint8_t* __restrict__ valid2, // [S, N2] or null
                    int N1, int N2, int D, int vec16,
                    int64_t* __restrict__ out_idx,      // [S, N1]
                    float* __restrict__ out_best,       // [S, N1]
                    float* __restrict__ out_second,     // [S, N1]
                    int32_t* __restrict__ launches) {   // [1] or null
  if constexpr (kEmpty) return;
  // the launch counter: one per launch, where the kernel runs (a replayed
  // CUDA graph counts too)
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0) {
    atomicAdd(launches, 1);
  }
  {  // this block's sequence
    const size_t s = blockIdx.y;
    d1 += s * N1 * D;
    d2 += s * N2 * D;
    if (valid2 != nullptr) valid2 += s * N2;
    out_idx += s * N1;
    out_best += s * N1;
    out_second += s * N1;
  }
  constexpr int kWarpsM = kBM / 16;         // warps over the rows (16 each)
  constexpr int kWarps = kWarpsM * kWarpsN;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kWN = kBN / kWarpsN;        // columns per warp
  constexpr int kNT = kWN / 8;              // n8 tiles per warp
  constexpr int kTPR = kThreads / kBM;      // threads per row, d1 norms

  extern __shared__ float4 smem4[];
  float* const sA = reinterpret_cast<float*>(smem4);  // [kBM][P]
  const int dk = padded(D), P = pitch_of(D);
  float* const sB = sA + kBM * P;                      // [2][kBN][P]
  __shared__ float sN1[kBM];
  __shared__ float sPb[kWarpsN][kBM], sPs[kWarpsN][kBM];  // column warps'
  __shared__ int sPi[kWarpsN][kBM];                       // partials
  __shared__ float sRb[kBM], sRs[kBM];  // the block's partial, read by
  __shared__ int sRi[kBM];              // rank 0

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int m0 = (blockIdx.x / kRanks) * kBM;
  const int lo = static_cast<int>(static_cast<int64_t>(rank) * N2 / kRanks);
  const int hi = static_cast<int>(static_cast<int64_t>(rank + 1) * N2 / kRanks);
  const int ntiles = (hi - lo + kBN - 1) / kBN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;

  // Zero the padded dimensions [D, dk) of every staged row once: the
  // copies never write them.
  if (dk > D) {
    const int pad = dk - D;
    for (int e = tid; e < (kBM + 2 * kBN) * pad; e += kThreads) {
      const int r = e / pad;
      sA[r * P + D + (e - r * pad)] = 0.0f;
    }
  }
  stage_rows<kWarps>(sA, d1, m0, N1, kBM, D, P, vec16);
  if (ntiles > 0) stage_rows<kWarps>(sB, d2, lo, hi, kBN, D, P, vec16);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  {
    const int r = tid / kTPR, part = tid % kTPR;
    float s = 0.0f;
    for (int k = part; k < D; k += kTPR) s = fmaf(sA[r * P + k], sA[r * P + k], s);
#pragma unroll
    for (int off = kTPR / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (part == 0) sN1[r] = s;
  }

  // Rows wm*16 + g (h = 0) and + 8 (h = 1) of the block's tile.
  float best[2], second[2];
  int idx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best[h] = kBig;
    second[h] = kBig;
    idx[h] = 0;
  }
  float n1[2];

  for (int it = 0; it < ntiles; ++it) {
    // Tile `it` has landed for every thread, and every thread is done
    // with the other buffer (and, at it == 0, sN1 is written).
    __syncthreads();
    if (it == 0) {
      n1[0] = sN1[wm * 16 + g];
      n1[1] = sN1[wm * 16 + g + 8];
    }
    const int n0 = lo + it * kBN;
    if (it + 1 < ntiles) {
      stage_rows<kWarps>(sB + ((it + 1) & 1) * kBN * P, d2, n0 + kBN, hi,
                         kBN, D, P, vec16);
      cp_async_commit();
    }
    // The flags of this thread's columns, wn*kWN + 8j + 2t + q.
    bool ok[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + wn * kWN + 8 * j + 2 * t + q;
        ok[j][q] = n < hi && (valid2 == nullptr || __ldg(valid2 + n));
      }

    float acc[kNT][4], small[kNT][4], nrm[kNT];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      nrm[j] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[j][q] = 0.0f;
        small[j][q] = 0.0f;
      }
    }
    // The dot product does not care in which order the dimensions meet
    // the MMA's k slots, so thread t takes dimensions kc + 8t .. kc + 8t
    // + 7 of each 32-dimension chunk: in MMA step s, dimension 8t + 2s
    // fills k slot t and 8t + 2s + 1 fills slot t + 4, alike for d1 and
    // d2. Each row's 8 values are then two 16-byte loads.
    const float* const a0 = sA + (wm * 16 + g) * P + 8 * t;
    const float* const b0 = sB + (it & 1) * kBN * P + (wn * kWN + g) * P + 8 * t;
    for (int kc = 0; kc < dk; kc += kKC) {
      uint32_t ahi[4][4], alo[4][4];  // [step][fragment register]
      {
        float x[2][8];  // rows g and g + 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 u = *reinterpret_cast<const float4*>(a0 + h * 8 * P + kc);
          const float4 v = *reinterpret_cast<const float4*>(a0 + h * 8 * P + kc + 4);
          x[h][0] = u.x; x[h][1] = u.y; x[h][2] = u.z; x[h][3] = u.w;
          x[h][4] = v.x; x[h][5] = v.y; x[h][6] = v.z; x[h][7] = v.w;
        }
        // fragment a0 (g, slot t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          split_tf32(x[0][2 * st], ahi[st][0], alo[st][0]);
          split_tf32(x[1][2 * st], ahi[st][1], alo[st][1]);
          split_tf32(x[0][2 * st + 1], ahi[st][2], alo[st][2]);
          split_tf32(x[1][2 * st + 1], ahi[st][3], alo[st][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* b = b0 + j * 8 * P + kc;
        const float4 u = *reinterpret_cast<const float4*>(b);
        const float4 v = *reinterpret_cast<const float4*>(b + 4);
        const float y[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) nrm[j] = fmaf(y[q], y[q], nrm[j]);
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          // fragment b0 (slot t, n = g), b1 (slot t + 4, n = g)
          uint32_t bhi[2], blo[2];
          split_tf32(y[2 * st], bhi[0], blo[0]);
          split_tf32(y[2 * st + 1], bhi[1], blo[1]);
          mma_tf32(small[j], alo[st], bhi);
          mma_tf32(small[j], ahi[st], blo);
          mma_tf32(part, ahi[st], bhi);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += part[q];
      }
    }

    // This tile's distances into the running state, columns ascending:
    // accumulator q holds row g + 8 (q / 2), column 2t + (q % 2); the
    // norm of column c sits (after the quad sum) in lanes 4c .. 4c + 3.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      nrm[j] += __shfl_xor_sync(0xffffffffu, nrm[j], 1);
      nrm[j] += __shfl_xor_sync(0xffffffffu, nrm[j], 2);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float n2 = __shfl_sync(0xffffffffu, nrm[j], 4 * (2 * t + q));
        const int n = n0 + wn * kWN + 8 * j + 2 * t + q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float g2 = acc[j][2 * h + q] + small[j][2 * h + q];
          const float d = ok[j][q] ? fmaxf(n1[h] + n2 - 2.0f * g2, 0.0f) : kBig;
          if (n < hi) fold(best[h], second[h], idx[h], d, n);
        }
      }
    }
    cp_async_wait_all();  // the next tile, before the barrier above
  }

  // The four threads of a row (lanes differing in their low 2 bits).
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float b2 = __shfl_xor_sync(0xffffffffu, best[h], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, second[h], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx[h], off);
      merge(best[h], second[h], idx[h], b2, s2, i2);
    }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + g + 8 * h;
      sPb[wn][r] = best[h];
      sPs[wn][r] = second[h];
      sPi[wn][r] = idx[h];
    }
  }
  __syncthreads();
  // The column warps of a row, in column order.
  if (tid < kBM) {
    float b = sPb[0][tid], s = sPs[0][tid];
    int i = sPi[0][tid];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) merge(b, s, i, sPb[w][tid], sPs[w][tid], sPi[w][tid]);
    sRb[tid] = b;
    sRs[tid] = s;
    sRi[tid] = i;
  }
  // The ranks of the cluster, in rank order, by rank 0.
  cluster.sync();
  if (rank == 0 && tid < kBM && m0 + tid < N1) {
    float b = sRb[tid], s = sRs[tid];
    int i = sRi[tid];
#pragma unroll
    for (int q = 1; q < kRanks; ++q) {
      const float rb = cluster.map_shared_rank(&sRb[0], q)[tid];
      const float rs = cluster.map_shared_rank(&sRs[0], q)[tid];
      const int ri = cluster.map_shared_rank(&sRi[0], q)[tid];
      merge(b, s, i, rb, rs, ri);
    }
    out_idx[m0 + tid] = i;
    out_best[m0 + tid] = b;
    out_second[m0 + tid] = s;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

template <int kBM, int kWarpsN, bool kEmpty>
int launch(const float* d1, const float* d2, const uint8_t* valid2, int S,
           int N1, int N2, int D, int64_t* idx, float* best, float* second,
           cudaStream_t stream, int32_t* launches) {
  // Once per instantiation, on the first (eager) call: allow the dynamic
  // shared memory of the widest rows, kMaxD.
  static const cudaError_t attr = cudaFuncSetAttribute(
      match_stream_kernel<kBM, kWarpsN, kEmpty>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<kBM>(kMaxD)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int vec16 = D % 4 == 0 && reinterpret_cast<uintptr_t>(d1) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(d2) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks * ((N1 + kBM - 1) / kBM), S);
  cfg.blockDim = dim3(32 * kBM / 16 * kWarpsN);
  cfg.dynamicSmemBytes = smem_bytes<kBM>(D);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kRanks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, match_stream_kernel<kBM, kWarpsN, kEmpty>, d1, d2, valid2, N1, N2, D,
      vec16, idx, best, second, launches);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// 64-row tiles once they give two blocks on each SM, else 32-row tiles
// (the EKF step's 256 rows: 8 clusters of 8, 64 blocks).
// The choice looks at N1 alone, never at S, so a batched launch runs each
// sequence with the single launch's tile.
template <bool kEmpty>
int dispatch(const float* d1, const float* d2, const uint8_t* valid2, int S,
             int N1, int N2, int D, int64_t* idx, float* best, float* second,
             void* stream, int32_t* launches) {
  if (S < 1 || S > 65535 || N1 < 1 || N2 < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (kRanks * ((N1 + 63) / 64) >= kWaveBlocks) {
    return launch<64, 2, kEmpty>(d1, d2, valid2, S, N1, N2, D, idx, best,
                                 second, st, launches);
  }
  return launch<32, 4, kEmpty>(d1, d2, valid2, S, N1, N2, D, idx, best, second,
                               st, launches);
}

}  // namespace

// Launches K2 over S sequences on `stream` (layouts above; a single
// problem is S = 1). Returns the launch's error, then cudaGetLastError()
// (0 = cudaSuccess), or cudaErrorInvalidValue without launching when a
// size is out of range (1 <= S <= 65535, N1, N2 >= 1, 1 <= D <= 256).
// `valid2` may be null (every column valid). `launches` ([1] int32 on the
// device, or null) gains one when the kernel runs.
extern "C" int match_stream_launch(const float* d1, const float* d2,
                                   const uint8_t* valid2, int S, int N1,
                                   int N2, int D, int64_t* idx, float* best,
                                   float* second, void* stream,
                                   int32_t* launches) {
  return dispatch<false>(d1, d2, valid2, S, N1, N2, D, idx, best, second,
                         stream, launches);
}

// An empty kernel at K2's launch configuration for S sequences of this
// shape (grid, cluster, threads, dynamic shared memory): the launch floor.
extern "C" int match_stream_floor_launch(int S, int N1, int N2, int D,
                                         void* stream) {
  return dispatch<true>(nullptr, nullptr, nullptr, S, N1, N2, D, nullptr,
                        nullptr, nullptr, stream, nullptr);
}
