"""Peak rate of the legacy warp-level tensor-core MMA (mma.sync) on a card.

K2 (csrc/match_stream.cu) runs its product as 3xTF32 on
``mma.sync.m16n8k8`` TF32; this probe measures what that instruction can
give at most, so K2's time can be read against it and not only against
the data sheet's rate (which is wgmma's). Each warp issues back-to-back
MMAs on 8 independent accumulators, with no memory traffic, over a grid
that fills every SM; the rate is the MMAs' flops over the CUDA-event
time of one long launch. Run it from the root of a checkout on a card:

    python3 -m pre3_tpu_torch.utils.mma_probe

It builds its kernel with the package's nvcc flags under build/kernels/.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess

import torch

from pre3_tpu_torch.utils.cuda_build import BUILD_DIR, NVCC_FLAGS, find_nvcc

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// 8 independent accumulators per warp, `iters` rounds of 8 MMAs each.
template <int kKind>
__global__ void probe(int iters, float* out) {
  float c[8][4] = {};
  const uint32_t a0 = 0x3f800000u + threadIdx.x, b0 = 0x3f000000u + threadIdx.x;
  uint32_t a[4] = {a0, a0 + 1, a0 + 2, a0 + 3}, b[2] = {b0, b0 + 1};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (kKind == 0) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 12345.0f) out[0] = s;  // keeps the MMAs live
}

extern "C" int probe_launch(int kind, int blocks, int warps, int iters,
                            float* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (kind == 0) probe<0><<<blocks, 32 * warps, 0, s>>>(iters, out);
  else probe<1><<<blocks, 32 * warps, 0, s>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# (name, kind, flops per MMA)
KINDS = (("mma.sync m16n8k8 tf32", 0, 2 * 16 * 8 * 8),
         ("mma.sync m16n8k16 bf16", 1, 2 * 16 * 8 * 16))


def _library() -> ctypes.CDLL:
    digest = hashlib.sha256((SOURCE + " ".join(NVCC_FLAGS)).encode())
    out = BUILD_DIR / f"libmma_probe_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(SOURCE)
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.probe_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.probe_launch.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mma_probe: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = _library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, kind, flops in KINDS:
        for warps in (4, 8, 16):
            blocks, iters = 4 * sms, 4096
            for _ in range(2):  # the first launch warms up
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                rc = lib.probe_launch(kind, blocks, warps, iters,
                                      out.data_ptr(), stream)
                stop.record()
                stop.synchronize()
                if rc:
                    raise RuntimeError(f"probe launch failed: cudaError {rc}")
            ms = start.elapsed_time(stop)
            mmas = blocks * warps * iters * 8
            print(f"{name}: {warps} warps x {blocks} blocks, {ms:.3f} ms, "
                  f"{mmas * flops / ms / 1e9:.1f} TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
