// Shared-memory set-up of the kernels that stage their candidates in
// shared memory (K1 and K1b in zanlungo_bucketed.cuh, K4 in
// zanlungo_dense.cu).
#pragma once

#include <atomic>
#include <cstddef>

#include <cuda_runtime.h>

namespace crowdsim {

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Opts `kernel` into the SM's whole shared memory, once per device: the
// carveout (several blocks share an SM) and the largest dynamic size a
// block may take.  `done` holds a bit for each device already set; each
// kernel keeps its own.
inline cudaError_t opt_in_shared_memory(const void* kernel,
                                        std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  int max_smem = 0;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace crowdsim
