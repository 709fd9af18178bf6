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
// with 0 <= bpos[r] < slots.  Slots are unique, so no row is lost: the TPU
// kernel's window overflow count has no counterpart here and is 0.
//
// Bound on the H100: bytes.  At the 1M bench scene (1.84M slots) the
// inputs need 68 MB (feat_t, bpos) and the planes 176 MB, so 0.073 ms at
// 3.35 TB/s (utils/roofline.py k3_bytes).
//
// Design: every slot's 96 bytes are written once, by slot, with
// coalesced stores in both planes (the first design filled both planes
// with the sentinel and then wrote the ~1M filled slots again: 336 MB
// over two kernels, its packed_T stores 4 bytes apart by `slots`).
//   (a) One thread per row scatters the inverse map inv[bpos[r]] = r
//       (8 MB; sorted rows write it in order).  inv is scratch that
//       nobody clears: an entry that no row targets keeps whatever it
//       held, so
//   (b) one thread per quarter slot (4 features) reads x = inv[s] and
//       takes row x only if x is a row and bpos[x] == s.  Slots are
//       unique, so that test names the one row that targets s, or none,
//       whatever inv held before (a):  no clearing pass is needed.  The
//       quarter's 4 features come from feat_t [16, N] (8 slots of a warp
//       read runs of 8 rows of one feature), and the warp stores 32
//       consecutive float4s of packed_t (512 contiguous bytes) and, for
//       the first two quarters, runs of 8 slots of packed_T's rows.
#include <cuda_runtime.h>

#include "zanlungo_pair.cuh"

namespace crowdsim {

__global__ void pack_inverse_kernel(const int* __restrict__ bpos, int n,
                                    int slots, int* __restrict__ inv) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int s = bpos[r];
  if (s >= 0 && s < slots) inv[s] = r;
}

__global__ void pack_slots_kernel(const float* __restrict__ feat_t,
                                  const int* __restrict__ bpos,
                                  const int* __restrict__ inv, int n,
                                  int slots, float4* __restrict__ packed_t,
                                  float* __restrict__ packed_T) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4LL * slots) return;
  const int s = (int)(i >> 2);
  const int f0 = 4 * (int)(i & 3);
  const int x = inv[s];
  const bool hit = x >= 0 && x < n && bpos[x] == s;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = hit ? feat_t[(long long)(f0 + j) * n + x]
               : sentinel_feature(f0 + j);
  packed_t[i] = make_float4(v[0], v[1], v[2], v[3]);
  if (f0 < NUM_CAND) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      packed_T[(long long)(f0 + j) * slots + s] = v[j];
  }
}

}  // namespace crowdsim

extern "C" int crowdsim_pack_rows(const float* feat_t, const int* bpos,
                                  int* inv, int n, int slots, float* packed_t,
                                  float* packed_T, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (n > 0) {
    crowdsim::pack_inverse_kernel<<<(n + threads - 1) / threads, threads, 0,
                                    st>>>(bpos, n, slots, inv);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long quarters = 4LL * slots;
  if (quarters > 0) {
    crowdsim::pack_slots_kernel<<<(unsigned)((quarters + threads - 1) /
                                             threads),
                                  threads, 0, st>>>(
        feat_t, bpos, inv, n, slots, reinterpret_cast<float4*>(packed_t),
        packed_T);
  }
  return (int)cudaGetLastError();
}
