// K3: pack tile-sorted feature rows into the bucketed plane.
//
// Replaces the TPU kernel rmf_crowdsim_tpu/ops/pack_pallas.py:
// pack_rows_pallas / _make_kernel (one program per 512-slot group that
// streams its rows through VMEM and places them with one-hot MXU matmuls,
// because row scatters are slow on the TPU).
//
// Contract (ops/pack.py): packed_t [slots, 16] and packed_T [8, slots]
// hold the sentinel row (position 1e30, id -1, zeros elsewhere) in every
// slot no row targets, and row r's features in slot bpos[r] for every row
// with bpos[r] < slots.  Slots are unique, so no row is lost: the TPU
// kernel's window overflow count has no counterpart here and is 0.
//
// Design.  Kernel (a) writes the sentinel into both planes, one thread per
// 16-byte vector.  Kernel (b) runs one thread per sorted row: it reads the
// row's 16 features from feat_t [16, N] (coalesced along N across the
// warp), writes them into packed_t as four 16-byte stores and the first 8
// into packed_T.
//
// Bound on the H100: bytes.  At the 1M bench scene (1.84M slots) the fill
// writes 176 MB and the scatter reads 64 MB and writes another ~96 MB, so
// ~0.1 ms at HBM rate; the scattered packed_T stores (4-byte, strided by
// slots) are the least efficient part.  Writing the sentinel only into
// slots no row fills would save the fill's bytes: later work.
#include <cuda_runtime.h>

#include "zanlungo_pair.cuh"

namespace crowdsim {

__global__ void pack_fill_kernel(float4* __restrict__ packed_t,
                                 float* __restrict__ packed_T,
                                 long long slots) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // packed_t: 4 float4 per slot; vector v holds features 4*(v%4)..+3.
  if (i < 4 * slots) {
    const int f0 = 4 * (int)(i & 3);
    packed_t[i] = make_float4(sentinel_feature(f0), sentinel_feature(f0 + 1),
                              sentinel_feature(f0 + 2),
                              sentinel_feature(f0 + 3));
  } else if (i < 4 * slots + NUM_CAND * slots) {
    const long long j = i - 4 * slots;
    packed_T[j] = sentinel_feature((int)(j / slots));
  }
}

__global__ void pack_scatter_kernel(const float* __restrict__ feat_t,
                                    const int* __restrict__ bpos, int n,
                                    long long slots,
                                    float4* __restrict__ packed_t,
                                    float* __restrict__ packed_T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int s = bpos[r];
  if (s < 0 || s >= slots) return;
  float v[NUM_F];
#pragma unroll
  for (int f = 0; f < NUM_F; ++f) v[f] = feat_t[(long long)f * n + r];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    packed_t[4 * (long long)s + k] =
        make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
#pragma unroll
  for (int f = 0; f < NUM_CAND; ++f) packed_T[f * slots + s] = v[f];
}

}  // namespace crowdsim

extern "C" int crowdsim_pack_rows(const float* feat_t, const int* bpos, int n,
                                  int slots, float* packed_t, float* packed_T,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long fill = (4LL + crowdsim::NUM_CAND) * slots;
  crowdsim::pack_fill_kernel<<<(unsigned)((fill + threads - 1) / threads),
                               threads, 0, st>>>(
      reinterpret_cast<float4*>(packed_t), packed_T, slots);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    crowdsim::pack_scatter_kernel<<<(n + threads - 1) / threads, threads, 0,
                                    st>>>(
        feat_t, bpos, n, slots, reinterpret_cast<float4*>(packed_t),
        packed_T);
  }
  return (int)cudaGetLastError();
}
