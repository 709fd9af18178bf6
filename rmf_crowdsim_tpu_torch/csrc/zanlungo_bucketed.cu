// K1 and K1b, as the main path runs them: the kernel (its contract,
// bound and design) is zanlungo_bucketed.cuh; this source instantiates
// its full form, K1 with and without integer priorities and K1b with and
// without, behind the C entry points that ops/zanlungo_bucketed.py calls.
// The stage probe's cuts of the same kernel are k1_stages.cu.
#include <cuda_runtime.h>

#include "zanlungo_bucketed.cuh"

extern "C" int crowdsim_zanlungo_bucketed(
    const float* zp5, const float* packed_t, const float* packed_T,
    float* out, int* overflow, int tx, int ty, int bucket, int T,
    int threads, int int_prio, void* stream) {
  cudaError_t e = crowdsim::check_geometry(bucket, T, threads, 0);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = int_prio ? crowdsim::launch<true, false>(
                     zp5, packed_t, packed_T, nullptr, nullptr, out,
                     overflow, tx, ty, bucket, T, threads, 1, 0, s)
               : crowdsim::launch<false, false>(
                     zp5, packed_t, packed_T, nullptr, nullptr, out,
                     overflow, tx, ty, bucket, T, threads, 1, 0, s);
  return (int)e;
}

extern "C" int crowdsim_zanlungo_bucketed_spill(
    const float* zp5, const float* packed_t, const float* packed_T,
    const int* sflag, const float* sp_T, float* out, int* overflow, int tx,
    int ty, int bucket, int T, int threads, int sub_tiles, int n_sp,
    int int_prio, void* stream) {
  if (sub_tiles <= 0 || ty % sub_tiles || n_sp <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = crowdsim::check_geometry(bucket, T, threads, n_sp);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = int_prio ? crowdsim::launch<true, true>(
                     zp5, packed_t, packed_T, sflag, sp_T, out, overflow, tx,
                     ty, bucket, T, threads, sub_tiles, n_sp, s)
               : crowdsim::launch<false, true>(
                     zp5, packed_t, packed_T, sflag, sp_T, out, overflow, tx,
                     ty, bucket, T, threads, sub_tiles, n_sp, s);
  return (int)e;
}

extern "C" const char* crowdsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
