// A device timestamp probe for the tracer (pre3_tpu_torch/utils/profiling.py).
//
// One thread reads the device's global nanosecond clock (%globaltimer),
// takes the next slot of a ring with one atomicAdd on the ring's cursor
// and writes (tag, time) there. Launched on the current stream, it runs
// after everything queued before it on that stream and before anything
// queued after it, so the difference of two probes' times is the device
// time of the work between them. A CUDA graph capture records the launch
// as a node with the ring's address, and every replay of the graph takes
// fresh slots: no host involvement and no synchronize per replay.
//
// The cursor keeps counting past the ring's capacity; a probe that finds
// no slot writes nothing, and the host reads cursor - capacity as the
// probes dropped. A null ring (a program's warm-up before its capture)
// launches the kernel and writes nothing, so the module is loaded before
// any capture.

#include <cstdint>

#include <cuda_runtime.h>

__global__ void probe_kernel(unsigned long long* cursor, long long* ring,
                             long long capacity, long long tag) {
  if (ring == nullptr) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long slot = atomicAdd(cursor, 1ULL);
  if (slot < static_cast<unsigned long long>(capacity)) {
    ring[2 * slot] = tag;
    ring[2 * slot + 1] = static_cast<long long>(now);
  }
}

// One probe on ``stream``: ``ring`` holds ``capacity`` (tag, ns) pairs of
// int64, ``cursor`` one uint64. Returns the launch's cudaError_t.
extern "C" int probe_launch(void* cursor, void* ring, long long capacity,
                            long long tag, void* stream) {
  probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(cursor), static_cast<long long*>(ring),
      capacity, tag);
  return static_cast<int>(cudaGetLastError());
}
