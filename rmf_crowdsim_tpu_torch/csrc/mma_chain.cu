// P3: a dependency-chained 0/1 matrix product, on the tensor cores and
// off them.
//
// Replaces the TPU probe perf/onehot_int8_probe.py (_probe_kernel :25,
// time_variant :49, pallas_call :54), which times `iters` chained products
// x <- tile(x @ w > 64) at the TPU kernel's compaction shapes (the
// prefix triangle [64,128] @ [128,128] and the one-hot [8,384] @
// [384,128]) in bf16 -> f32, int8 -> int32 and f32 -> f32, to learn what
// one product costs the MXU.  Here the same chain runs in one block on
// the H100: `mma.sync` in bf16 (m16n8k16 -> f32), s8 (m16n8k32 -> s32) and
// tf32 (m16n8k8 -> f32), and, as the analog of the TPU's f32 -> f32, a
// plain FFMA loop with no tensor core.  Every product of 0/1 values is
// exact in all four types.
//
// Contract (probes/mma_chain.py): x0 [m, k] and w [k, n] f32 holding 0
// or 1, k a multiple of n.  Step: acc = x @ w; bit = acc > 64; x[r,
// c] = bit[r, c % n].  After `iters` >= 1 steps, out = x[:, :n] and acc
// is the last step's product, both [m, n] f32.
//
// Bound: what truly binds the chain is its latency.  Each step needs the
// whole previous product, so one block on one SM runs it, and a step
// costs the latency of its k / K dependent mma instructions, a barrier,
// the threshold and a second barrier; 2 m k n operations a step over the
// card's dense peak (utils/roofline.py mma_bound) is far below that.
//
// Design: x [mp, k] (m padded to 16 rows of zeros) and w^T [n, k] live in
// shared memory in the input type, each row padded by 16 bytes so that
// the eight rows a fragment load touches fall in distinct banks.  Eight
// warps split the 16 x 8 output tiles (at most eight each, kept in
// registers); a step runs their products, waits, writes the bits back into
// x, and waits.  The FFMA form keeps x [m, k] and w [k, n] unpadded and
// gives each thread one column of up to 32 rows.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace crowdsim {
namespace {

constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_MAX_TILES = 8;      // 16 x 8 output tiles a warp
constexpr int FFMA_MAX_ROWS = 32;     // output rows a thread, FFMA form
constexpr int MMA_BF16 = 0, MMA_S8 = 1, MMA_TF32 = 2, MMA_F32 = 3;
constexpr int THRESH = 64;           // the TPU probe's threshold

// The fragments of mma.sync (PTX ISA, "Matrix Fragments for mma.m16n8k*"):
// lane = 4 g + t.  A [16, K] row-major from x (leading dimension ld), B
// [K, 8] from w^T (leading dimension ld, one row of w^T a column of B),
// C [16, 8]: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8.
template <int TYPE>
struct Mma;

template <>
struct Mma<MMA_BF16> {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int K = 16;
  __device__ static T from_float(float v) { return __float2bfloat16_rn(v); }
  __device__ static float to_float(T v) { return __bfloat162float(v); }
  // a0,a1: row g, cols 2t, 2t+1; a2,a3: row g+8; a4..a7: cols + 8.
  __device__ static void load(const T* x, const T* wt, int ld, int r0,
                              int n0, int k0, int g, int t, uint32_t (&a)[4],
                              uint32_t (&b)[2]) {
    a[0] = *reinterpret_cast<const uint32_t*>(x + (r0 + g) * ld + k0 + 2 * t);
    a[1] = *reinterpret_cast<const uint32_t*>(x + (r0 + g + 8) * ld + k0 +
                                              2 * t);
    a[2] = *reinterpret_cast<const uint32_t*>(x + (r0 + g) * ld + k0 +
                                              2 * t + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(x + (r0 + g + 8) * ld + k0 +
                                              2 * t + 8);
    // b0,b1: rows 2t, 2t+1 of column g; b2,b3: rows + 8.
    b[0] = *reinterpret_cast<const uint32_t*>(wt + (n0 + g) * ld + k0 + 2 * t);
    b[1] = *reinterpret_cast<const uint32_t*>(wt + (n0 + g) * ld + k0 +
                                              2 * t + 8);
  }
  __device__ static void mma(Acc (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<MMA_S8> {
  using T = int8_t;
  using Acc = int;
  static constexpr int K = 32;
  __device__ static T from_float(float v) { return (T)v; }
  __device__ static float to_float(T v) { return (float)v; }
  // a0..a3: row g, cols 4t .. 4t+3; a4..a7: row g+8; a8..a15: cols + 16.
  __device__ static void load(const T* x, const T* wt, int ld, int r0,
                              int n0, int k0, int g, int t, uint32_t (&a)[4],
                              uint32_t (&b)[2]) {
    a[0] = *reinterpret_cast<const uint32_t*>(x + (r0 + g) * ld + k0 + 4 * t);
    a[1] = *reinterpret_cast<const uint32_t*>(x + (r0 + g + 8) * ld + k0 +
                                              4 * t);
    a[2] = *reinterpret_cast<const uint32_t*>(x + (r0 + g) * ld + k0 +
                                              4 * t + 16);
    a[3] = *reinterpret_cast<const uint32_t*>(x + (r0 + g + 8) * ld + k0 +
                                              4 * t + 16);
    // b0..b3: rows 4t .. 4t+3 of column g; b4..b7: rows + 16.
    b[0] = *reinterpret_cast<const uint32_t*>(wt + (n0 + g) * ld + k0 + 4 * t);
    b[1] = *reinterpret_cast<const uint32_t*>(wt + (n0 + g) * ld + k0 +
                                              4 * t + 16);
  }
  __device__ static void mma(Acc (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<MMA_TF32> {
  using T = float;
  using Acc = float;
  static constexpr int K = 8;
  __device__ static T from_float(float v) { return v; }
  __device__ static float to_float(T v) { return v; }
  // a0: row g, col t; a1: row g+8; a2, a3: cols + 4.
  __device__ static void load(const T* x, const T* wt, int ld, int r0,
                              int n0, int k0, int g, int t, uint32_t (&a)[4],
                              uint32_t (&b)[2]) {
    a[0] = __float_as_uint(x[(r0 + g) * ld + k0 + t]);
    a[1] = __float_as_uint(x[(r0 + g + 8) * ld + k0 + t]);
    a[2] = __float_as_uint(x[(r0 + g) * ld + k0 + t + 4]);
    a[3] = __float_as_uint(x[(r0 + g + 8) * ld + k0 + t + 4]);
    // b0: row t of column g; b1: row t + 4.
    b[0] = __float_as_uint(wt[(n0 + g) * ld + k0 + t]);
    b[1] = __float_as_uint(wt[(n0 + g) * ld + k0 + t + 4]);
  }
  __device__ static void mma(Acc (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

struct MmaLayout {
  int mp, ld;
  size_t x_bytes, bytes;
};

template <int TYPE>
__host__ __device__ MmaLayout mma_layout(int m, int k, int n) {
  using T = typename Mma<TYPE>::T;
  MmaLayout L;
  L.mp = (m + 15) / 16 * 16;
  L.ld = k + (int)(16 / sizeof(T));
  L.x_bytes = align16(sizeof(T) * L.mp * L.ld);
  L.bytes = L.x_bytes + align16(sizeof(T) * n * L.ld);
  return L;
}

template <int TYPE>
__global__ void __launch_bounds__(MMA_THREADS)
    mma_chain_kernel(const float* __restrict__ x0,
                     const float* __restrict__ w, float* __restrict__ out,
                     float* __restrict__ acc_out, int m, int k, int n,
                     int iters) {
  using M = Mma<TYPE>;
  using T = typename M::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout L = mma_layout<TYPE>(m, k, n);
  T* xs = reinterpret_cast<T*>(smem);
  T* wt = reinterpret_cast<T*>(smem + L.x_bytes);
  const int ld = L.ld;
  for (int i = threadIdx.x; i < L.mp * k; i += blockDim.x) {
    const int r = i / k;
    xs[r * ld + i % k] = M::from_float(r < m ? x0[i] : 0.f);
  }
  for (int i = threadIdx.x; i < n * k; i += blockDim.x) {
    const int c = i / k;
    const int kk = i % k;
    wt[c * ld + kk] = M::from_float(w[kk * n + c]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tiles_n = n / 8;
  const int tiles = (L.mp / 16) * tiles_n;
  const int copies = k / n;
  typename M::Acc d[MMA_MAX_TILES][4];

  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < MMA_MAX_TILES; ++u) {
      const int tile = warp + u * MMA_WARPS;
      if (tile < tiles) {
        const int r0 = (tile / tiles_n) * 16;
        const int n0 = (tile % tiles_n) * 8;
#pragma unroll
        for (int i = 0; i < 4; ++i) d[u][i] = 0;
        for (int k0 = 0; k0 < k; k0 += M::K) {
          uint32_t a[4], b[2];
          M::load(xs, wt, ld, r0, n0, k0, g, t, a, b);
          M::mma(d[u], a, b);
        }
      }
    }
    __syncthreads();  // every warp has read x
#pragma unroll
    for (int u = 0; u < MMA_MAX_TILES; ++u) {
      const int tile = warp + u * MMA_WARPS;
      if (tile < tiles) {
        const int r0 = (tile / tiles_n) * 16;
        const int n0 = (tile % tiles_n) * 8;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + g + (i >= 2 ? 8 : 0);
          const int col = n0 + 2 * t + (i & 1);
          const T bit = M::from_float(d[u][i] > THRESH ? 1.f : 0.f);
          for (int q = 0; q < copies; ++q) xs[row * ld + col + q * n] = bit;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < MMA_MAX_TILES; ++u) {
    const int tile = warp + u * MMA_WARPS;
    if (tile < tiles) {
      const int r0 = (tile / tiles_n) * 16;
      const int n0 = (tile % tiles_n) * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + (i >= 2 ? 8 : 0);
        const int col = n0 + 2 * t + (i & 1);
        if (row < m) {
          out[row * n + col] = M::to_float(xs[row * ld + col]);
          acc_out[row * n + col] = (float)d[u][i];
        }
      }
    }
  }
}

__host__ __device__ size_t ffma_bytes(int m, int k, int n) {
  return align16(sizeof(float) * m * k) + sizeof(float) * k * n;
}

// The FFMA form: no tensor core; each fmaf is one FFMA (the library is
// built with -fmad=false, which leaves explicit fmaf alone).  Thread t
// takes column c = t % n of rows t / n, t / n + 256 / n, ..., so it loads
// one w value a k step and reads x four k steps at a time.
__global__ void __launch_bounds__(MMA_THREADS)
    ffma_chain_kernel(const float* __restrict__ x0,
                      const float* __restrict__ w, float* __restrict__ out,
                      float* __restrict__ acc_out, int m, int k, int n,
                      int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + align16(sizeof(float) * m * k));
  for (int i = threadIdx.x; i < m * k; i += blockDim.x) xs[i] = x0[i];
  for (int i = threadIdx.x; i < k * n; i += blockDim.x) ws[i] = w[i];
  __syncthreads();

  const int c = threadIdx.x % n;
  const int r0 = threadIdx.x / n;
  const int rstep = blockDim.x / n;
  const int copies = k / n;
  float acc[FFMA_MAX_ROWS];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < FFMA_MAX_ROWS; ++j) acc[j] = 0.f;
    for (int kk = 0; kk < k; kk += 4) {
      const float w0 = ws[kk * n + c];
      const float w1 = ws[(kk + 1) * n + c];
      const float w2 = ws[(kk + 2) * n + c];
      const float w3 = ws[(kk + 3) * n + c];
#pragma unroll
      for (int j = 0; j < FFMA_MAX_ROWS; ++j) {
        const int r = r0 + j * rstep;
        if (r < m) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * k + kk);
          acc[j] = fmaf(xv.x, w0, acc[j]);
          acc[j] = fmaf(xv.y, w1, acc[j]);
          acc[j] = fmaf(xv.z, w2, acc[j]);
          acc[j] = fmaf(xv.w, w3, acc[j]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FFMA_MAX_ROWS; ++j) {
      const int r = r0 + j * rstep;
      if (r < m) {
        const float bit = acc[j] > (float)THRESH ? 1.f : 0.f;
        for (int q = 0; q < copies; ++q) xs[r * k + c + q * n] = bit;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < FFMA_MAX_ROWS; ++j) {
    const int r = r0 + j * rstep;
    if (r < m) {
      out[r * n + c] = xs[r * k + c];
      acc_out[r * n + c] = acc[j];
    }
  }
}

template <int TYPE>
cudaError_t launch_mma(const float* x0, const float* w, float* out,
                       float* acc, int m, int k, int n, int iters,
                       cudaStream_t stream) {
  static std::atomic<unsigned> configured{0};
  const MmaLayout L = mma_layout<TYPE>(m, k, n);
  if (k % Mma<TYPE>::K || (L.mp / 16) * (n / 8) > MMA_WARPS * MMA_MAX_TILES)
    return cudaErrorInvalidValue;
  cudaError_t e = opt_in_shared_memory(
      reinterpret_cast<const void*>(mma_chain_kernel<TYPE>), configured);
  if (e != cudaSuccess) return e;
  mma_chain_kernel<TYPE><<<1, MMA_THREADS, L.bytes, stream>>>(
      x0, w, out, acc, m, k, n, iters);
  return cudaGetLastError();
}

cudaError_t launch_ffma(const float* x0, const float* w, float* out,
                        float* acc, int m, int k, int n, int iters,
                        cudaStream_t stream) {
  static std::atomic<unsigned> configured{0};
  if (MMA_THREADS % n || m > (MMA_THREADS / n) * FFMA_MAX_ROWS || k % 4)
    return cudaErrorInvalidValue;
  cudaError_t e = opt_in_shared_memory(
      reinterpret_cast<const void*>(ffma_chain_kernel), configured);
  if (e != cudaSuccess) return e;
  ffma_chain_kernel<<<1, MMA_THREADS, ffma_bytes(m, k, n), stream>>>(
      x0, w, out, acc, m, k, n, iters);
  return cudaGetLastError();
}

}  // namespace
}  // namespace crowdsim

// type: 0 bf16, 1 s8, 2 tf32 (mma.sync), 3 f32 (FFMA).  The wrapper
// (probes/mma_chain.py) checks the shapes and the shared memory first.
extern "C" int crowdsim_mma_chain(const float* x0, const float* w,
                                  float* out, float* acc, int m, int k,
                                  int n, int iters, int type,
                                  void* stream) {
  using namespace crowdsim;
  if (m < 1 || n < 8 || n % 8 || k % n || iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type) {
    case MMA_BF16:
      return (int)launch_mma<MMA_BF16>(x0, w, out, acc, m, k, n, iters, s);
    case MMA_S8:
      return (int)launch_mma<MMA_S8>(x0, w, out, acc, m, k, n, iters, s);
    case MMA_TF32:
      return (int)launch_mma<MMA_TF32>(x0, w, out, acc, m, k, n, iters, s);
    case MMA_F32:
      return (int)launch_ffma(x0, w, out, acc, m, k, n, iters, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
