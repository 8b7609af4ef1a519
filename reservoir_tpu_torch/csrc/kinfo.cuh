// What the build made of a kernel, for the timing lines of chip_smoke.py:
// registers a thread, local memory a thread (spills), static and dynamic
// shared memory a block, and the warps an SM keeps resident at that launch
// shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
#pragma once

#include <cuda_runtime.h>

namespace kinfo {

// out[0] registers a thread, out[1] local bytes a thread, out[2] static
// shared bytes a block, out[3] dynamic shared bytes a block, out[4] resident
// warps an SM.  Returns a cudaError_t code.
template <typename Kernel>
inline int query(Kernel* kernel, int threads, size_t dyn_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dyn_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn_smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = static_cast<int>(dyn_smem);
  out[4] = blocks * threads / 32;
  return static_cast<int>(cudaSuccess);
}

}  // namespace kinfo
