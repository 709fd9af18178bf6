// P4: in-kernel transposes, and writing the [slots, 16] feature plane.
//
// Replaces the TPU probe perf/transpose_probe.py: probe_kernel_transpose
// (:51; pallas_call :59 and :73: does an in-kernel [8, 128] -> [128, 8]
// and [8, 64] -> [64, 8] transpose lower, and is it right) and
// probe_column_updates (:83: what refreshing K columns of a row-major
// [slots, 16] plane from K [slots] vectors costs against rebuilding the
// plane by a stack).  The feature plane is what the dense path's
// dense_prep stacks every step and what the bucketed paths' pack writes,
// so the writers measure that cost on the H100.
//
// Contracts (probes/planes.py), with s = 1.0000001f as the probe's
// multiply:
//   transpose: y [C, R] = the first C columns of x [R, ld], transposed;
//              one block, through shared memory.
//   columns:   plane[i, j] = c_j[i] * s for j < K (K = 4 or 8), plane
//              [slots, 16] row-major, its other columns untouched.
//   rebuild:   plane[i, j] = plane[i, j + 8] = c_j[i] * s for j < 8.
//   rows:      t[j, i] = c_j[i] * s for j < K, t [8, slots].
// One rounding each (a multiply), so kernel and plain version agree bit
// for bit.
//
// Bound: bytes.  Each writer reads its K vectors once and writes its K
// (rebuild: 16) floats a slot once; a thread takes one slot, reads its
// vectors' floats (coalesced across the warp) and writes the row's floats
// as 16-byte stores.  The transposes move 4-8 KB: one launch's latency.
#include <cuda_runtime.h>

namespace crowdsim {
namespace {

constexpr int PLANE_THREADS = 256;
constexpr int PLANE_F = 16;
constexpr float PROBE_SCALE = 1.0000001f;

__global__ void transpose_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int R, int C,
                                 int ld) {
  extern __shared__ float tile[];  // [R][C + 1]
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C;
    const int c = i % C;
    tile[r * (C + 1) + c] = x[r * ld + c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int c = i / R;
    const int r = i % R;
    y[i] = tile[r * (C + 1) + c];
  }
}

struct Cols {
  const float* c[8];
};

// mode 0: K columns of the plane; 1: the rebuild; 2: K rows of t.
template <int MODE, int K>
__global__ void __launch_bounds__(PLANE_THREADS)
    plane_kernel(float* __restrict__ dst, Cols cols, int slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= slots) return;
  float v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = cols.c[j][i] * PROBE_SCALE;
  if constexpr (MODE == 2) {
#pragma unroll
    for (int j = 0; j < K; ++j) dst[(long long)j * slots + i] = v[j];
  } else {
    float4* row = reinterpret_cast<float4*>(dst + (long long)i * PLANE_F);
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      row[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                           v[4 * q + 3]);
    if constexpr (MODE == 1) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q)
        row[K / 4 + q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                     v[4 * q + 3]);
    }
  }
}

template <int MODE, int K>
cudaError_t launch_plane(float* dst, const Cols& cols, int slots,
                         cudaStream_t stream) {
  const int blocks = (slots + PLANE_THREADS - 1) / PLANE_THREADS;
  plane_kernel<MODE, K><<<blocks, PLANE_THREADS, 0, stream>>>(dst, cols,
                                                              slots);
  return cudaGetLastError();
}

}  // namespace
}  // namespace crowdsim

extern "C" int crowdsim_transpose(const float* x, float* y, int R, int C,
                                  int ld, void* stream) {
  using namespace crowdsim;
  const size_t smem = sizeof(float) * R * (C + 1);
  if (R < 1 || C < 1 || C > ld || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  transpose_kernel<<<1, PLANE_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(x, y, R, C, ld);
  return (int)cudaGetLastError();
}

// mode 0 (columns, K 4 or 8), 1 (rebuild, K 8), 2 (rows, K 4 or 8);
// c4..c7 may be null where K is 4.
extern "C" int crowdsim_plane_write(float* dst, const float* c0,
                                    const float* c1, const float* c2,
                                    const float* c3, const float* c4,
                                    const float* c5, const float* c6,
                                    const float* c7, int slots, int K,
                                    int mode, void* stream) {
  using namespace crowdsim;
  const Cols cols{{c0, c1, c2, c3, c4, c5, c6, c7}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots < 1) return (int)cudaErrorInvalidValue;
  if (mode == 0 && K == 8) return (int)launch_plane<0, 8>(dst, cols, slots, s);
  if (mode == 0 && K == 4) return (int)launch_plane<0, 4>(dst, cols, slots, s);
  if (mode == 1 && K == 8) return (int)launch_plane<1, 8>(dst, cols, slots, s);
  if (mode == 2 && K == 8) return (int)launch_plane<2, 8>(dst, cols, slots, s);
  if (mode == 2 && K == 4) return (int)launch_plane<2, 4>(dst, cols, slots, s);
  return (int)cudaErrorInvalidValue;
}
