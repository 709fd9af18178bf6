// P3: a dependency-chained 0/1 matrix product, on the tensor cores and
// off them.
//
// Replaces the TPU probe perf/onehot_int8_probe.py (_probe_kernel :25,
// time_variant :49, pallas_call :54), which times `iters` chained products
// x <- tile(x @ w > 64) at the TPU kernel's compaction shapes (the
// prefix triangle [64,128] @ [128,128] and the one-hot [8,384] @
// [384,128]) in bf16 -> f32, int8 -> int32 and f32 -> f32, to learn what
// one product costs the MXU.  Here the chain runs on the H100 in bf16
// (mma.sync m16n8k16 -> f32), s8 (m16n8k32 -> s32) and tf32 (m16n8k8 ->
// f32), and, as the analog of the TPU's f32 -> f32, on the FFMA units.
// Every product of 0/1 values is exact in all four types, and so is every
// partial sum in any order: the outputs are bitwise the plain chain's.
//
// Contract (probes/mma_chain.py): x0 [m, k] and w [k, n] f32 holding 0
// or 1, k a multiple of n.  Step: acc = x @ w; bit = acc > 64; x[r,
// c] = bit[r, c % n].  After `iters` >= 1 steps, out = x[:, :n] and acc
// is the last step's product, both [m, n] f32.
//
// Bound: row r of step i + 1 depends only on row r of step i, so the rows
// are independent chains, but each link of a row waits for the link
// before: at least one dependent mma (or fmaf) with its threshold and
// conversion, whose time mma_link_kernel measures (utils/roofline.py
// mma_chain_bound); 2 m k n operations a link at the card's dense peak is
// the rate bound beside it.  Both are loose: a link of mma_rows_kernel
// runs k / (K KSPLIT) dependent mma.sync on each accumulator, not one.
//
// Design, at the two probe shapes (k, n) = (128, 128) and (384, 128), both
// template parameters, for any m <= 64:
// - mma.sync (mma_rows_kernel): one block a 16-row tile (rows past m are
//   zeros and stay zeros), its warps splitting the n columns.  Each warp
//   keeps the B fragments of its columns for every k step in registers,
//   loaded once.  A link runs the warp's products, with KSPLIT partial
//   accumulators a tile along k so that the dependent depth is k / (K
//   KSPLIT); sums them (integers: exact), thresholds, repacks its own
//   columns into the A fragments of the k steps they make (the C -> A
//   maps, probes/mma_chain.py repack_sources), stores them in fragment
//   order into one of two exchange buffers, waits at a named barrier of
//   the block's warps, and reads every k step's A fragment back with one
//   16-byte (tf32: 8-byte, the 0/1 values as their upper halves) load a
//   lane.  The k / n tiled copies reuse the same A registers.
// - FFMA (ffma_rows_kernel): one block a row; SEG lanes take a group of
//   COLS columns, each lane a k segment of w for them in registers; the x
//   row sits in shared memory (two buffers), read as float4 broadcasts,
//   each feeding 4 COLS fmaf; four partial sums a column and lane, a
//   shuffle sum across the segments, one barrier a link.
// Other accepted shapes take the generic one-block kernels at the end.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace crowdsim {
namespace {

constexpr int MMA_BF16 = 0, MMA_S8 = 1, MMA_TF32 = 2, MMA_F32 = 3;
constexpr int THRESH = 64;           // the TPU probe's threshold
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bitf(float v) {
  return v > (float)THRESH ? 1.f : 0.f;
}
__device__ __forceinline__ uint32_t bitu(int v) { return v > THRESH; }

// The fragments of mma.sync (PTX ISA, "Matrix Fragments for mma.m16n8k*";
// probes/mma_chain.py fragment_map): lane = 4 g + t.  A [16, K]: register
// r holds EA elements of row g + 8 (r & 1), columns (K / 2) (r >> 1) + EA
// t + e.  B [K, 8]: register r holds EA elements of column g, rows (K / 2)
// r + EA t + e.  C [16, 8]: c0, c1 at row g, columns 2t, 2t + 1; c2, c3
// at row g + 8.
template <int TYPE>
struct Mma;

template <>
struct Mma<MMA_BF16> {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int K = 16;
  static constexpr int EA = 2;      // elements a 32-bit register
  static constexpr int WORDS = 4;   // exchange words a lane and k step
  __device__ static T from_float(float v) { return __float2bfloat16_rn(v); }
  __device__ static float to_float(T v) { return __bfloat162float(v); }
  __device__ static uint32_t pack(const float (&v)[EA]) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  // Generic kernel: a0,a1: row g, cols 2t, 2t+1; a2,a3: row g+8;
  // a4..a7: cols + 8.
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
  // The A fragment of k step u from the C fragments of n tiles 2u and
  // 2u + 1 of the same lane: the identity (probes/mma_chain.py
  // repack_sources, "bf16").
  template <int NT>
  __device__ static void repack(const Acc (&c)[NT][4], int u, int,
                                uint32_t (&a)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const Acc* ct = c[2 * u + (r >> 1)];
      const float v[2] = {bitf(ct[2 * (r & 1)]), bitf(ct[2 * (r & 1) + 1])};
      a[r] = pack(v);
    }
  }
  __device__ static void store(uint32_t* buf, const uint32_t (&a)[4]) {
    *reinterpret_cast<uint4*>(buf) = make_uint4(a[0], a[1], a[2], a[3]);
  }
  __device__ static void fetch(const uint32_t* buf, uint32_t (&a)[4]) {
    const uint4 v = *reinterpret_cast<const uint4*>(buf);
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  }
};

template <>
struct Mma<MMA_S8> {
  using T = int8_t;
  using Acc = int;
  static constexpr int K = 32;
  static constexpr int EA = 4;
  static constexpr int WORDS = 4;
  __device__ static T from_float(float v) { return (T)v; }
  __device__ static float to_float(T v) { return (float)v; }
  __device__ static uint32_t pack(const float (&v)[EA]) {
    uint32_t r = 0;
#pragma unroll
    for (int e = 0; e < EA; ++e) r |= (uint32_t)(uint8_t)(int8_t)v[e] << (8 * e);
    return r;
  }
  // Generic kernel: a0..a3: row g, cols 4t .. 4t+3; a4..a7: row g+8;
  // a8..a15: cols + 16.
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
  // The A fragment of k step u (n tiles 4u .. 4u + 3), by a shuffle inside
  // each quad (probes/mma_chain.py repack_sources, "s8").  Register r
  // (row half h = r & 1, tile pair p = r >> 1) of lane t holds columns 4t
  // .. 4t + 3 of tile 4u + 2p + (t >> 1): the two bit pairs that lanes
  // 2 (t & 1) and 2 (t & 1) + 1 of the quad hold there.  Each lane packs
  // word[h][p] = its bytes (c[2h], c[2h + 1]) of tile 2p, then of tile
  // 2p + 1; lane t reads the word of both sources and keeps halfword
  // t >> 1 of each (byte_perm 0x5410 or 0x7632).
  template <int NT>
  __device__ static void repack(const Acc (&c)[NT][4], int u, int lane,
                                uint32_t (&a)[4]) {
    const int t = lane & 3;
    const int lo = (lane & ~3) | (2 * (t & 1));
    const uint32_t sel = (t >> 1) ? 0x7632u : 0x5410u;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r & 1, p = r >> 1;
      const Acc* c0 = c[4 * u + 2 * p];
      const Acc* c1 = c[4 * u + 2 * p + 1];
      const uint32_t word = bitu(c0[2 * h]) | bitu(c0[2 * h + 1]) << 8 |
                            bitu(c1[2 * h]) << 16 | bitu(c1[2 * h + 1]) << 24;
      a[r] = __byte_perm(__shfl_sync(FULL, word, lo),
                         __shfl_sync(FULL, word, lo + 1), sel);
    }
  }
  __device__ static void store(uint32_t* buf, const uint32_t (&a)[4]) {
    *reinterpret_cast<uint4*>(buf) = make_uint4(a[0], a[1], a[2], a[3]);
  }
  __device__ static void fetch(const uint32_t* buf, uint32_t (&a)[4]) {
    const uint4 v = *reinterpret_cast<const uint4*>(buf);
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  }
};

template <>
struct Mma<MMA_TF32> {
  using T = float;
  using Acc = float;
  static constexpr int K = 8;
  static constexpr int EA = 1;
  static constexpr int WORDS = 2;   // the upper halves of a0..a3
  __device__ static T from_float(float v) { return v; }
  __device__ static float to_float(T v) { return v; }
  __device__ static uint32_t pack(const float (&v)[EA]) {
    return __float_as_uint(v[0]);
  }
  // Generic kernel: a0: row g, col t; a1: row g+8; a2, a3: cols + 4.
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
  // The A fragment of k step u (n tile u), by a shuffle inside each quad
  // (probes/mma_chain.py repack_sources, "tf32").  Lane t needs column t
  // (a[h]) and t + 4 (a[h + 2]) of row half h: entry c[2h + (t & 1)] of
  // lanes t >> 1 and 2 + (t >> 1).  Shuffle 1: lane s sends c[2h + (s >>
  // 1)], lane t reads lane ((t & 1) << 1) | (t >> 1); shuffle 2: lane s
  // sends c[2h + 1 - (s >> 1)], lane t reads that lane ^ 2.  An even
  // lane gets a[h] from shuffle 1 and a[h + 2] from 2, an odd lane the
  // other way round.
  template <int NT>
  __device__ static void repack(const Acc (&c)[NT][4], int u, int lane,
                                uint32_t (&a)[4]) {
    const int t = lane & 3;
    const int src = (lane & ~3) | ((t & 1) << 1) | (t >> 1);
    const Acc* ct = c[u];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v1 = bitf((t >> 1) ? ct[2 * h + 1] : ct[2 * h]);
      const float v2 = bitf((t >> 1) ? ct[2 * h] : ct[2 * h + 1]);
      const float s1 = __shfl_sync(FULL, v1, src);
      const float s2 = __shfl_sync(FULL, v2, src ^ 2);
      a[h] = __float_as_uint((t & 1) ? s2 : s1);
      a[h + 2] = __float_as_uint((t & 1) ? s1 : s2);
    }
  }
  // 0.0f and 1.0f have zero lower halves: the exchange keeps the upper.
  __device__ static void store(uint32_t* buf, const uint32_t (&a)[4]) {
    *reinterpret_cast<uint2*>(buf) = make_uint2(
        __byte_perm(a[0], a[1], 0x7632), __byte_perm(a[2], a[3], 0x7632));
  }
  __device__ static void fetch(const uint32_t* buf, uint32_t (&a)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(buf);
    a[0] = v.x << 16, a[1] = v.x & 0xffff0000u;
    a[2] = v.y << 16, a[3] = v.y & 0xffff0000u;
  }
};

// A fragment of k step k0 of rows r0 .. r0 + 15 from x [m, k] f32 (rows
// past m are zeros), and B fragment of k step k0, columns n0 .. n0 + 7
// from w [k, n] f32.
template <int TYPE>
__device__ void load_a_global(const float* __restrict__ x, int m, int k,
                              int r0, int k0, int lane, uint32_t (&a)[4]) {
  using M = Mma<TYPE>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + g + 8 * (r & 1);
    const int col = k0 + (M::K / 2) * (r >> 1) + M::EA * t;
    float v[M::EA];
#pragma unroll
    for (int e = 0; e < M::EA; ++e) v[e] = row < m ? x[row * k + col + e] : 0.f;
    a[r] = M::pack(v);
  }
}

template <int TYPE>
__device__ void load_b_global(const float* __restrict__ w, int n, int n0,
                              int k0, int lane, uint32_t (&b)[2]) {
  using M = Mma<TYPE>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + (M::K / 2) * r + M::EA * t;
    float v[M::EA];
#pragma unroll
    for (int e = 0; e < M::EA; ++e) v[e] = w[(row + e) * n + n0 + g];
    b[r] = M::pack(v);
  }
}

// The bits and the product of a warp's C fragments (rows r0 + g, r0 + g +
// 8; n tiles from n0) into out and acc_out [m, n].
template <int NT, typename Acc>
__device__ void write_rows(const Acc (&c)[NT][4], float* __restrict__ out,
                           float* __restrict__ acc_out, int m, int n, int r0,
                           int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i >> 1);
      const int col = n0 + 8 * nt + 2 * t + (i & 1);
      if (row < m) {
        out[row * n + col] = bitf((float)c[nt][i]);
        acc_out[row * n + col] = (float)c[nt][i];
      }
    }
}

// A barrier over the block's `threads` threads (barrier 1; __syncthreads
// is barrier 0).
__device__ __forceinline__ void named_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// mma.sync: one block a 16-row tile, WARPS warps splitting its n columns
// ---------------------------------------------------------------------------

template <int TYPE, int K, int N, int WARPS, int KSPLIT>
__global__ void __launch_bounds__(32 * WARPS, 1)
    mma_rows_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                    float* __restrict__ out, float* __restrict__ acc_out,
                    int m, int iters) {
  using M = Mma<TYPE>;
  using Acc = typename M::Acc;
  constexpr int KK = M::K;
  constexpr int KS = K / KK;           // k steps a product
  constexpr int JN = N / KK;           // distinct k steps from link 2 on
  constexpr int NT = N / 8 / WARPS;    // n tiles a warp
  constexpr int JW = NT * 8 / KK;      // k steps a warp's columns make
  static_assert(K % N == 0 && N % (8 * WARPS) == 0 && JW >= 1 &&
                    JW * KK == NT * 8,
                "a warp's columns must make whole k steps");
  // Two exchange buffers: A fragments of the JN k steps in fragment order
  // (k step, lane, WORDS words).
  __shared__ __align__(16) uint32_t xbuf[2][JN * 32 * M::WORDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * 16, n0 = warp * NT * 8;

  uint32_t b[NT][KS][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < KS; ++j)
      load_b_global<TYPE>(w, N, n0 + 8 * nt, j * KK, lane, b[nt][j]);

  Acc acc[NT][KSPLIT][4];
  Acc c[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int s = 0; s < KSPLIT; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][s][i] = 0;
  // Link 1 reads x0, every k step its own columns.
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint32_t a[4];
    load_a_global<TYPE>(x0, m, K, r0, j * KK, lane, a);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) M::mma(acc[nt][j % KSPLIT], a, b[nt][j]);
  }
  for (int it = 1;; ++it) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Acc sum = acc[nt][0][i];
#pragma unroll
        for (int s = 1; s < KSPLIT; ++s) sum += acc[nt][s][i];
        c[nt][i] = sum;
      }
    if (it == iters) break;
    uint32_t* buf = xbuf[it & 1];
#pragma unroll
    for (int u = 0; u < JW; ++u) {
      uint32_t a[4];
      M::template repack<NT>(c, u, lane, a);
      M::store(buf + ((warp * JW + u) * 32 + lane) * M::WORDS, a);
    }
    named_barrier(32 * WARPS);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int s = 0; s < KSPLIT; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][s][i] = 0;
#pragma unroll
    for (int jj = 0; jj < JN; ++jj) {
      uint32_t a[4];
      M::fetch(buf + (jj * 32 + lane) * M::WORDS, a);
#pragma unroll
      for (int q = 0; q < K / N; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          M::mma(acc[nt][(q * JN + jj) % KSPLIT], a, b[nt][q * JN + jj]);
    }
  }
  write_rows<NT>(c, out, acc_out, m, N, r0, n0, lane);
}

// ---------------------------------------------------------------------------
// FFMA: one block a row; SEG lanes a group of COLS columns, each lane a k
// segment of w for those columns
// ---------------------------------------------------------------------------

// Each fmaf is one FFMA (the library is built with -fmad=false, which
// leaves explicit fmaf alone).  Lane s of column group grp (columns grp +
// j N / COLS) holds w[s KL .. (s + 1) KL - 1, those columns] in registers
// and reads the same k segment of x, stored at a stride of KL + 4 floats
// so that the SEG segments' float4 reads fall in distinct banks; each
// float4 of x feeds 4 COLS fmaf.
template <int K, int N, int SEG, int COLS>
__global__ void __launch_bounds__(N / COLS * SEG, 1)
    ffma_rows_kernel(const float* __restrict__ x0,
                     const float* __restrict__ w, float* __restrict__ out,
                     float* __restrict__ acc_out, int iters) {
  constexpr int KL = K / SEG, LD = KL + 4, COPIES = K / N, NC = N / COLS;
  static_assert(K % SEG == 0 && KL % 4 == 0 && 32 % SEG == 0 &&
                    N % COLS == 0,
                "segments and column groups");
  __shared__ __align__(16) float xs[2][SEG * LD];
  const int row = blockIdx.x;
  const int s = threadIdx.x % SEG, grp = threadIdx.x / SEG;
  float wr[COLS][KL];
#pragma unroll
  for (int j = 0; j < COLS; ++j)
#pragma unroll
    for (int i = 0; i < KL; ++i) wr[j][i] = w[(s * KL + i) * N + grp + j * NC];
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    xs[0][(i / KL) * LD + i % KL] = x0[row * K + i];
  __syncthreads();
  float total[COLS], bit[COLS];
  for (int it = 0; it < iters; ++it) {
    const float* xv = xs[it & 1] + s * LD;
    float p[COLS][4];
#pragma unroll
    for (int j = 0; j < COLS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) p[j][q] = 0.f;
#pragma unroll
    for (int i = 0; i < KL; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xv + i);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        p[j][0] = fmaf(v.x, wr[j][i], p[j][0]);
        p[j][1] = fmaf(v.y, wr[j][i + 1], p[j][1]);
        p[j][2] = fmaf(v.z, wr[j][i + 2], p[j][2]);
        p[j][3] = fmaf(v.w, wr[j][i + 3], p[j][3]);
      }
    }
    float* xn = xs[(it + 1) & 1];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      total[j] = (p[j][0] + p[j][1]) + (p[j][2] + p[j][3]);
#pragma unroll
      for (int o = 1; o < SEG; o <<= 1)
        total[j] += __shfl_xor_sync(FULL, total[j], o);
      bit[j] = bitf(total[j]);
      for (int q = s; q < COPIES; q += SEG) {
        const int idx = grp + j * NC + q * N;
        xn[(idx / KL) * LD + idx % KL] = bit[j];
      }
    }
    __syncthreads();
  }
  if (s == 0) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      out[row * N + grp + j * NC] = bit[j];
      acc_out[row * N + grp + j * NC] = total[j];
    }
  }
}

// ---------------------------------------------------------------------------
// The latency of one link: one warp, `links` dependent steps
// ---------------------------------------------------------------------------

// Each link is the smallest product of the type whose A operand is the
// threshold of the previous link's result, converted back to the input
// type (bf16: a0 = (bit d0, bit d1), a1 = (bit d2, bit d3), a2 = a0, a3 =
// a1; s8: every register the bytes (bit d0, .., bit d3); tf32: a_r = bit
// d_r), or, for f32, one fma.rn whose first operand is the threshold of
// the one before.  A starts as ones, every B element is -LINK_C / K and
// the C operand LINK_C, so a link of ones gives 0 and a link of zeros
// LINK_C: the bits alternate, and the result after `links` links tells
// their parity.
constexpr int LINK_C = 2 * THRESH;

template <int TYPE>
__global__ void __launch_bounds__(32) mma_link_kernel(float* out, int links) {
  using M = Mma<TYPE>;
  float ones[M::EA], bs[M::EA];
#pragma unroll
  for (int e = 0; e < M::EA; ++e) ones[e] = 1.f, bs[e] = -LINK_C / M::K;
  uint32_t one = M::pack(ones), bw = M::pack(bs);
  asm volatile("mov.b32 %0, %0;\n" : "+r"(one));  // opaque to the compiler
  asm volatile("mov.b32 %0, %0;\n" : "+r"(bw));
  uint32_t a[4] = {one, one, one, one};
  const uint32_t b[2] = {bw, bw};
  typename M::Acc d[4];
#pragma unroll 4
  for (int i = 0; i < links; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = LINK_C;
    M::mma(d, a, b);
    if constexpr (TYPE == MMA_BF16) {
      const float v0[2] = {bitf(d[0]), bitf(d[1])};
      const float v1[2] = {bitf(d[2]), bitf(d[3])};
      a[0] = a[2] = M::pack(v0);
      a[1] = a[3] = M::pack(v1);
    } else if constexpr (TYPE == MMA_S8) {
      a[0] = a[1] = a[2] = a[3] = bitu(d[0]) | bitu(d[1]) << 8 |
                                  bitu(d[2]) << 16 | bitu(d[3]) << 24;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = __float_as_uint(bitf(d[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) out[threadIdx.x * 4 + r] = (float)d[r];
}

__global__ void __launch_bounds__(32) fma_link_kernel(float* out, int links) {
  float wv = -65.f, cv = 65.5f, v = 65.5f;
  asm volatile("mov.b32 %0, %0;\n" : "+f"(wv));
  asm volatile("mov.b32 %0, %0;\n" : "+f"(cv));
#pragma unroll 4
  for (int i = 0; i < links; ++i) {
    const float x = bitf(v);
    asm volatile("fma.rn.f32 %0, %1, %2, %3;\n"
                 : "=f"(v)
                 : "f"(x), "f"(wv), "f"(cv));
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) out[threadIdx.x * 4 + r] = v;
}

// ---------------------------------------------------------------------------
// Generic: one block for any other accepted shape
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_MAX_TILES = 8;      // 16 x 8 output tiles a warp
constexpr int FFMA_MAX_ROWS = 32;     // output rows a thread, FFMA form

// x [mp, k] (m padded to 16 rows of zeros) and w^T [n, k] in shared
// memory in the input type, each row padded by 16 bytes so that the eight
// rows a fragment load touches fall in distinct banks.
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

// Eight warps split the 16 x 8 output tiles (at most eight each, kept in
// registers); a step runs their products, waits, writes the bits back into
// x, and waits.
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

// Thread t takes column c = t % n of rows t / n, t / n + 256 / n, ..., so
// it loads one w value a k step and reads x four k steps at a time.
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

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Args {
  const float* x0;
  const float* w;
  float* out;
  float* acc;
  int m, k, n, iters;
  cudaStream_t stream;
};

template <int TYPE, int K, int N, int WARPS, int KSPLIT>
cudaError_t launch_rows(const Args& p) {
  mma_rows_kernel<TYPE, K, N, WARPS, KSPLIT>
      <<<(p.m + 15) / 16, 32 * WARPS, 0, p.stream>>>(p.x0, p.w, p.out, p.acc,
                                                    p.m, p.iters);
  return cudaGetLastError();
}

template <int K, int N, int SEG, int COLS>
cudaError_t launch_ffma_rows(const Args& p) {
  ffma_rows_kernel<K, N, SEG, COLS>
      <<<p.m, N / COLS * SEG, 0, p.stream>>>(p.x0, p.w, p.out, p.acc,
                                              p.iters);
  return cudaGetLastError();
}

// The prefix shape (k = n = 128): 4 warps a row tile (4 n tiles each), one
// accumulator a tile; the FFMA form 2 lanes a column.  (Settings from a
// sweep on the H100; PERF.md.)
cudaError_t launch_prefix(int type, const Args& p) {
  switch (type) {
    case MMA_BF16: return launch_rows<MMA_BF16, 128, 128, 4, 1>(p);
    case MMA_S8: return launch_rows<MMA_S8, 128, 128, 4, 1>(p);
    case MMA_TF32: return launch_rows<MMA_TF32, 128, 128, 4, 2>(p);
    default: return launch_ffma_rows<128, 128, 2, 1>(p);
  }
}

// The one-hot shape (k = 384, n = 128): B for a warp's columns in
// registers sets the warps (bf16 8, s8 4: 96 registers each; tf32 8: 192);
// three partial accumulators along k (tf32: two); the FFMA form 8 lanes a
// group of 4 columns.  (Settings from a sweep on the H100.)
cudaError_t launch_one_hot(int type, const Args& p) {
  switch (type) {
    case MMA_BF16: return launch_rows<MMA_BF16, 384, 128, 8, 3>(p);
    case MMA_S8: return launch_rows<MMA_S8, 384, 128, 4, 3>(p);
    case MMA_TF32: return launch_rows<MMA_TF32, 384, 128, 8, 2>(p);
    default: return launch_ffma_rows<384, 128, 8, 4>(p);
  }
}

template <int TYPE>
cudaError_t launch_generic_mma(const Args& p) {
  static std::atomic<unsigned> configured{0};
  const MmaLayout L = mma_layout<TYPE>(p.m, p.k, p.n);
  if (p.k % Mma<TYPE>::K ||
      (L.mp / 16) * (p.n / 8) > MMA_WARPS * MMA_MAX_TILES)
    return cudaErrorInvalidValue;
  cudaError_t e = opt_in_shared_memory(
      reinterpret_cast<const void*>(mma_chain_kernel<TYPE>), configured);
  if (e != cudaSuccess) return e;
  mma_chain_kernel<TYPE><<<1, MMA_THREADS, L.bytes, p.stream>>>(
      p.x0, p.w, p.out, p.acc, p.m, p.k, p.n, p.iters);
  return cudaGetLastError();
}

cudaError_t launch_generic_ffma(const Args& p) {
  static std::atomic<unsigned> configured{0};
  if (MMA_THREADS % p.n || p.m > (MMA_THREADS / p.n) * FFMA_MAX_ROWS ||
      p.k % 4)
    return cudaErrorInvalidValue;
  cudaError_t e = opt_in_shared_memory(
      reinterpret_cast<const void*>(ffma_chain_kernel), configured);
  if (e != cudaSuccess) return e;
  ffma_chain_kernel<<<1, MMA_THREADS, ffma_bytes(p.m, p.k, p.n), p.stream>>>(
      p.x0, p.w, p.out, p.acc, p.m, p.k, p.n, p.iters);
  return cudaGetLastError();
}

cudaError_t launch_generic(int type, const Args& p) {
  switch (type) {
    case MMA_BF16: return launch_generic_mma<MMA_BF16>(p);
    case MMA_S8: return launch_generic_mma<MMA_S8>(p);
    case MMA_TF32: return launch_generic_mma<MMA_TF32>(p);
    default: return launch_generic_ffma(p);
  }
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
  if (m < 1 || m > 64 || n < 8 || n % 8 || k % n || iters < 1 ||
      type < MMA_BF16 || type > MMA_F32)
    return (int)cudaErrorInvalidValue;
  const Args p{x0, w, out, acc, m, k, n, iters,
               static_cast<cudaStream_t>(stream)};
  if (k == 128 && n == 128) return (int)launch_prefix(type, p);
  if (k == 384 && n == 128) return (int)launch_one_hot(type, p);
  return (int)launch_generic(type, p);
}

// One warp, `links` dependent links of type `type` (0 bf16, 1 s8, 2 tf32
// mma.sync; 3 f32 fma); out [32, 4] gets each lane's last result.
extern "C" int crowdsim_mma_link(float* out, int links, int type,
                                 void* stream) {
  using namespace crowdsim;
  if (links < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type) {
    case MMA_BF16: mma_link_kernel<MMA_BF16><<<1, 32, 0, s>>>(out, links); break;
    case MMA_S8: mma_link_kernel<MMA_S8><<<1, 32, 0, s>>>(out, links); break;
    case MMA_TF32: mma_link_kernel<MMA_TF32><<<1, 32, 0, s>>>(out, links); break;
    case MMA_F32: fma_link_kernel<<<1, 32, 0, s>>>(out, links); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
