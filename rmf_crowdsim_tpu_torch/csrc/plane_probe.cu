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
// The transposes move 4-8 KB: one launch's latency bounds them.  The two
// probe shapes take a kernel templated on R and C: one thread an element
// (1,024 or 512 threads), indices known at compile time (shifts, not
// runtime divisions), coalesced reads into the [R][C + 1] tile and one
// coalesced store a thread.  Every other shape takes the runtime-shape
// kernel (two strided loops over the block).
//
// The writers are byte-bound streams.  Each lane of a warp takes 4
// consecutive slots of a 128-slot chunk and reads each vector as one
// float4; a warp takes 8 / K chunks, so a lane has 8 float4 loads (128 B)
// in flight before its first store (at K = 4 one chunk's 64 B a lane
// left the rows writer well short of HBM rate on the H100); one warp a
// group of chunks, and a grid that covers them all (it streamed faster
// than a grid of the resident blocks striding over the chunks).  The
// rows writer stores float4s straight into t's contiguous rows.  The plane writers stage a chunk's
// 128 slots x K values in shared memory ([K][132] floats a warp: 132 = 4
// mod 32, so each store pattern below reads 32 banks) and store whole
// rows' spans: with W float4s to a row (columns x8: 2, rebuild: 4),
// 32 / W rows an instruction, so one warp store covers whole 32-byte
// sectors (columns x8) or 512 contiguous bytes (rebuild).
// columns x4 writes 16 B of each 64-B row, half a 32-B sector: its
// counted bytes are 16 B read and 16 B written a slot (32 B), but its
// stores touch one whole sector a slot, so the traffic the layout forces
// is 16 B read + 32 B written = 48 B a slot (utils/roofline.py
// plane_sector_bytes; more if the memory reads the sector to merge the
// half it keeps).  Shapes with slots % 4 != 0 or a pointer off 16 bytes
// take the per-slot kernel (scalar loads and stores, one slot a thread).
#include <cuda_runtime.h>

#include <cstdint>

namespace crowdsim {
namespace {

constexpr int PLANE_THREADS = 256;
constexpr int PLANE_F = 16;
constexpr float PROBE_SCALE = 1.0000001f;
constexpr int WARP_SLOTS = 128;        // 4 consecutive slots a lane
constexpr int STAGE_LD = WARP_SLOTS + 4;

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

// One thread an element of the R x C block (R * C threads).
template <int R, int C>
__global__ void __launch_bounds__(R * C)
    transpose_fixed_kernel(const float* __restrict__ x,
                           float* __restrict__ y, int ld) {
  __shared__ float tile[R][C + 1];
  const unsigned i = threadIdx.x;
  tile[i / C][i % C] = x[(i / C) * ld + i % C];
  __syncthreads();
  y[i] = tile[i % R][i / R];
}

struct Cols {
  const float* c[8];
};

// mode 0: K columns of the plane; 1: the rebuild; 2: K rows of t.  Any
// slot count and alignment.
template <int MODE, int K>
__global__ void __launch_bounds__(PLANE_THREADS)
    plane_kernel(float* __restrict__ dst, Cols cols, int slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= slots) return;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float v = cols.c[j][i] * PROBE_SCALE;
    if constexpr (MODE == 2) {
      dst[(long long)j * slots + i] = v;
    } else {
      dst[(long long)i * PLANE_F + j] = v;
      if constexpr (MODE == 1) dst[(long long)i * PLANE_F + K + j] = v;
    }
  }
}

__device__ __forceinline__ float4 scaled(float4 v) {
  return make_float4(v.x * PROBE_SCALE, v.y * PROBE_SCALE,
                     v.z * PROBE_SCALE, v.w * PROBE_SCALE);
}

// The same contracts for slots % 4 == 0 and 16-byte aligned pointers.
// A warp takes U = 8 / K chunks of 128 slots (4 consecutive slots a lane
// a chunk), so that each lane has 8 float4 loads in flight before its
// first store; one warp a group of chunks, the grid covering them all.
template <int MODE, int K>
__global__ void __launch_bounds__(PLANE_THREADS)
    plane_vec_kernel(float* __restrict__ dst, Cols cols, int slots) {
  constexpr int WARPS = PLANE_THREADS / 32;
  constexpr int U = 8 / K;
  constexpr int SK = MODE == 2 ? 1 : K;  // the rows writer stages nothing
  // float4s a row and rows a warp store instruction.
  constexpr int W = MODE == 1 ? 4 : K / 4;
  constexpr int ROWS = 32 / W;
  __shared__ __align__(16) float stage[WARPS][SK][STAGE_LD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g0 =
      ((long long)blockIdx.x * WARPS + warp) * U * WARP_SLOTS;
  if (g0 >= slots) return;
  float4 v[U][K];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long s = g0 + u * WARP_SLOTS + 4 * lane;
#pragma unroll
    for (int j = 0; j < K; ++j)
      v[u][j] = s < slots
                    ? scaled(*reinterpret_cast<const float4*>(cols.c[j] + s))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long s0 = g0 + u * WARP_SLOTS;
    const long long s = s0 + 4 * lane;
    if constexpr (MODE == 2) {
      if (s < slots) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          *reinterpret_cast<float4*>(dst + (long long)j * slots + s) =
              v[u][j];
      }
    } else {
      __syncwarp();  // the previous chunk's stores have read the stage
#pragma unroll
      for (int j = 0; j < K; ++j)
        *reinterpret_cast<float4*>(&stage[warp][j][4 * lane]) = v[u][j];
      __syncwarp();
      const int f = lane % W;            // which float4 of the row
      const int j0 = 4 * (f % (K / 4));  // its first value
#pragma unroll
      for (int q = 0; q < WARP_SLOTS / ROWS; ++q) {
        const int r = q * ROWS + lane / W;
        if (s0 + r < slots) {
          const float4 o =
              make_float4(stage[warp][j0][r], stage[warp][j0 + 1][r],
                          stage[warp][j0 + 2][r], stage[warp][j0 + 3][r]);
          *reinterpret_cast<float4*>(dst + (s0 + r) * PLANE_F + 4 * f) = o;
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int MODE, int K>
cudaError_t launch_plane(float* dst, const Cols& cols, int slots,
                         cudaStream_t stream) {
  bool vec = slots % 4 == 0 && aligned16(dst);
  for (int j = 0; j < K; ++j) vec = vec && aligned16(cols.c[j]);
  if (!vec) {
    const int blocks = (slots + PLANE_THREADS - 1) / PLANE_THREADS;
    plane_kernel<MODE, K><<<blocks, PLANE_THREADS, 0, stream>>>(dst, cols,
                                                                slots);
    return cudaGetLastError();
  }
  const long long block_slots =
      (long long)PLANE_THREADS / 32 * (8 / K) * WARP_SLOTS;
  const int blocks = (int)((slots + block_slots - 1) / block_slots);
  plane_vec_kernel<MODE, K><<<blocks, PLANE_THREADS, 0, stream>>>(dst, cols,
                                                                  slots);
  return cudaGetLastError();
}

}  // namespace
}  // namespace crowdsim

extern "C" int crowdsim_transpose(const float* x, float* y, int R, int C,
                                  int ld, void* stream) {
  using namespace crowdsim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * R * (C + 1);
  if (R < 1 || C < 1 || C > ld || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (R == 8 && C == 128)
    transpose_fixed_kernel<8, 128><<<1, 8 * 128, 0, s>>>(x, y, ld);
  else if (R == 8 && C == 64)
    transpose_fixed_kernel<8, 64><<<1, 8 * 64, 0, s>>>(x, y, ld);
  else
    transpose_kernel<<<1, PLANE_THREADS, smem, s>>>(x, y, R, C, ld);
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
