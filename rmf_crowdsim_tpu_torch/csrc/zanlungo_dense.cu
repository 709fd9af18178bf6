// K4: fused neighbour search + Zanlungo force over the dense tile-sorted
// rows (the grid_dense backend).
//
// Replaces the TPU kernel rmf_crowdsim_tpu/ops/zanlungo_dense.py:
// zanlungo_forces_dense / _make_dense_kernel (Pallas, one program per tile
// column: three whole-column strip DMAs, an in-kernel roll and transpose,
// 32-row sub-blocks dispatched to 128-lane compaction tiers, a 256-lane
// direct tier or a bounded full-column sweep by window extent).
//
// Contract (ops/zanlungo_dense.py): feat is [N, 16] f32, row i = sorted
// agent i; tile_start [tx * ty + 1] gives each tile's row range.  For
// every row of column c whose rank in the column is below col_cap:
// out[c * col_cap + rank] = rec + F / m, where t_i is the minimum time to
// collision over the live candidates with another id and strict
// d^2 < eye^2 among the rows of sort-time tiles tcy-1..tcy+1 (feature row
// 13) in columns c-1..c+1, columns outside the world skipped, and F (the
// sum of pair forces over the same set, taken column c-1, c, c+1, rows
// ascending in each) applies only where t_i is finite.  Dead query rows
// (id < 0) get their rec row; rows past the column's capacity are not
// written.  Optional counters: overflow[0] += queries that re-walk their
// window, overflow[1] += blocks that read their candidates in place.
//
// Bound on the H100: operations, barely.  At the 1M bench scene the f32
// operations that the inputs need (a mask test per live pair of a 3x3
// tile window, the pair math on the hits) take 0.033 ms at 67 TFLOP/s;
// the bytes (each live row's query and candidate features, each output
// row) take 0.019 ms at 3.35 TB/s (utils/roofline.py k4_work, k4_bytes).
//
// The first design (one thread per query row, no shared memory) ran at
// ~4% of that bound, held back by instruction issue: each warp walked the
// union of its lanes' three row ranges, one broadcast global load per
// candidate row, and did so twice (the TTC pass, then the force pass
// repeating every mask test): ~2 x 200 masked tests per query for ~157
// true candidates and ~9 neighbours, the rows read ~4 times.  This design
// takes K1's answers (csrc/zanlungo_bucketed.cuh):
//   1. Staging.  One block per (tile column c, run of T tile rows): its
//      queries are the rows of tiles (c, t0 .. t0+T-1) with rank below
//      col_cap, its candidates the rows of tiles t0-1 .. t0+T of columns
//      c-1, c, c+1: three contiguous row ranges, staged into shared memory
//      with coalesced loads as two float4 arrays, (px, py, id, prio) for
//      the mask walk's one 16-byte load a candidate and (vx, vy, fx, fy)
//      for the pair math.  Dense rows have no empty slots, so nothing is
//      compacted; rows that died since a carried binning keep id -1 and
//      the sentinel position, and the mask rejects them.
//   2. One mask pass.  Each query's window is three contiguous runs of the
//      stage; the mask pass appends each hit's staged index (uint16), in
//      walk order, to the query's LIST_CAP-entry list in shared memory;
//      the TTC and force passes walk the list.  A query with more hits
//      re-walks its window with the mask in each pass, in the same order,
//      so the result stays exact.
//   3. Threads on queries.  Consecutive threads take consecutive query
//      rows (the same or the next tile), so a warp's windows nearly
//      coincide, and a warp's pair phase follows its longest list.
//   4. Hotspots.  A block whose three ranges exceed the stage walks them
//      where they lie in global memory, with the mask in each pass, in the
//      same order: exact, and inside this kernel.
// Every query walks its candidates in the first design's order and does
// the same float operations on them, so the output is the first design's
// bit for bit (-fmad=false).
//
// Shared memory (dense_layout; k4_geometry in ops/zanlungo_dense.py
// mirrors it to refuse, before the launch, a block the H100 cannot hold):
// the stage, two float4 arrays [stage_rows]; the lists
// [LIST_CAP][threads] uint16.
#include <atomic>

#include <cuda_runtime.h>

#include "smem.cuh"
#include "zanlungo_pair.cuh"

namespace crowdsim {
namespace {

constexpr int LIST_CAP = 32;
constexpr int MAX_THREADS = 512;
constexpr int MAX_STAGE = 65536;  // staged indices are uint16

struct DenseLayout {
  size_t list_off;
  size_t bytes;
};

__host__ __device__ __forceinline__ DenseLayout dense_layout(int stage_rows,
                                                             int threads) {
  DenseLayout L;
  L.list_off = align16(2 * sizeof(float4) * (size_t)stage_rows);
  L.bytes = align16(L.list_off +
                    sizeof(unsigned short) * LIST_CAP * (size_t)threads);
  return L;
}

// Candidates staged in shared memory; j is a staged index.
struct Staged {
  const float4* P;  // px py id prio
  const float4* V;  // vx vy fx fy
  __device__ __forceinline__ float4 mask_row(int j) const { return P[j]; }
  __device__ __forceinline__ float4 pair_row(int j) const { return V[j]; }
};

// Candidates read where they lie; j is a row of feat (float4s: px py vx vy,
// fx fy prio id, ...).
struct InPlace {
  const float4* rows4;
  __device__ __forceinline__ float4 mask_row(int j) const {
    const float4 a = __ldg(rows4 + 4LL * j);
    const float4 b = __ldg(rows4 + 4LL * j + 1);
    return make_float4(a.x, a.y, b.w, b.z);
  }
  __device__ __forceinline__ float4 pair_row(int j) const {
    const float4 a = __ldg(rows4 + 4LL * j);
    const float4 b = __ldg(rows4 + 4LL * j + 1);
    return make_float4(a.z, a.w, b.x, b.y);
  }
};

// Calls f(j) for every candidate j of the three ranges [lo[k], hi[k])
// that the query's mask takes, in walk order.
template <class Rows, class F>
__device__ __forceinline__ void walk(const Query& q, const Rows& rows,
                                     const int (&lo)[3], const int (&hi)[3],
                                     F&& f) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll 4
    for (int j = lo[k]; j < hi[k]; ++j) {
      const float4 p = rows.mask_row(j);
      if (pair_mask(q, p.x, p.y, p.z)) f(j);
    }
  }
}

// The TTC and force passes of one live query, over its list (n_list hits,
// entry m at list[m * stride]) or, for n_list < 0, re-walking its window.
// Returns rec + F / m in (ox, oy).
template <bool INT_PRIO, class Rows>
__device__ __forceinline__ void query_forces(
    const Params& zp, float neg_inv_fd, float inv_mass, const Query& q,
    const Rows& rows, const int (&lo)[3], const int (&hi)[3],
    const unsigned short* list, int stride, int n_list, float& ox,
    float& oy) {
  float t_i = CUDART_INF_F;
  auto ttc = [&](int j) {
    const float4 p = rows.mask_row(j);
    const float4 v = rows.pair_row(j);
    t_i = fminf(t_i, pair_ttc(q, v.x, v.y, p.x, p.y, zp.agent_radius));
  };
  if (n_list < 0) {
    walk(q, rows, lo, hi, ttc);
  } else {
    for (int m = 0; m < n_list; ++m) ttc(list[m * stride]);
  }
  ox = q.rx;
  oy = q.ry;
  if (!isfinite(t_i)) return;
  const float inv_t = 1.f / (t_i > 0.f ? t_i : 1.f);
  float fx = 0.f;
  float fy = 0.f;
  auto force = [&](int j) {
    const float4 p = rows.mask_row(j);
    const float4 v = rows.pair_row(j);
    pair_force<INT_PRIO>(zp, t_i, inv_t, neg_inv_fd, q, p.x, p.y, v.x, v.y,
                         v.z, v.w, p.w, fx, fy);
  };
  if (n_list < 0) {
    walk(q, rows, lo, hi, force);
  } else {
    for (int m = 0; m < n_list; ++m) force(list[m * stride]);
  }
  ox = q.rx + fx * inv_mass;
  oy = q.ry + fy * inv_mass;
}

template <bool INT_PRIO>
__global__ void __launch_bounds__(MAX_THREADS)
    zanlungo_dense_kernel(const float* __restrict__ zp5,
                          const float* __restrict__ feat,
                          const int* __restrict__ tile_start,
                          float* __restrict__ out,
                          int* __restrict__ overflow, int tx, int ty,
                          int col_cap, int T, int stage_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DenseLayout L = dense_layout(stage_rows, blockDim.x);
  float4* P = reinterpret_cast<float4*>(smem);
  float4* V = P + stage_rows;
  unsigned short* lists = reinterpret_cast<unsigned short*>(smem + L.list_off);

  const int runs = (ty + T - 1) / T;
  const int c = blockIdx.x / runs;
  const int t0 = (blockIdx.x % runs) * T;
  const int t1 = min(t0 + T, ty);  // query tiles [t0, t1)
  const int cs = tile_start[c * ty];
  const int qa = tile_start[c * ty + t0];
  const int qb = min(tile_start[c * ty + t1], cs + col_cap);
  if (qa >= qb) return;  // the run holds no row below col_cap

  // Staged tiles [sa, sb) of columns c-1, c, c+1: range k holds rows
  // [glo_k, glo_k + len_k) at staged indices [off_k, off_k + len_k), so a
  // row r of range k sits at r - shift_k, shift_k = glo_k - off_k.
  const int sa = max(t0 - 1, 0);
  const int sb = min(t1 + 1, ty);
  int shift[3];
  int off[4];
  off[0] = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int ck = c + k - 1;
    int glo = 0;
    int len = 0;
    if (ck >= 0 && ck < tx) {
      glo = tile_start[ck * ty + sa];
      len = tile_start[ck * ty + sb] - glo;
    }
    off[k + 1] = off[k] + len;
    shift[k] = glo - off[k];
  }
  const int total = off[3];
  const bool staged = total <= stage_rows;
  const float4* rows4 = reinterpret_cast<const float4*>(feat);

  if (staged) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int s = i < off[1] ? shift[0] : (i < off[2] ? shift[1] : shift[2]);
      const float4 a = __ldg(rows4 + 4LL * (i + s));      // px py vx vy
      const float4 b = __ldg(rows4 + 4LL * (i + s) + 1);  // fx fy prio id
      P[i] = make_float4(a.x, a.y, b.w, b.z);
      V[i] = make_float4(a.z, a.w, b.x, b.y);
    }
    __syncthreads();
  } else if (threadIdx.x == 0 && overflow != nullptr) {
    atomicAdd(overflow + 1, 1);
  }

  const Params zp = load_params(zp5);
  const float neg_inv_fd = -1.f / zp.force_distance;
  const float inv_mass = 1.f / zp.agent_mass;
  unsigned short* list = lists + threadIdx.x;  // entry m: list[m * threads]
  const int stride = blockDim.x;
  float2* out2 = reinterpret_cast<float2*>(out);

  for (int row = qa + threadIdx.x; row < qb; row += blockDim.x) {
    const float4* r = rows4 + 4LL * row;
    const float4 a = __ldg(r);      // px py vx vy
    const float4 b = __ldg(r + 1);  // fx fy prio id
    const float4 e = __ldg(r + 2);  // rx ry eye spx
    const float4 g = __ldg(r + 3);  // spy tcy (feature 13) 0 1
    Query q;
    q.px = a.x;
    q.py = a.y;
    q.vx = a.z;
    q.vy = a.w;
    q.prio = b.z;
    q.id = b.w;
    q.rx = e.x;
    q.ry = e.y;
    q.eye = e.z;
    q.spx = e.w;
    q.spy = g.x;
    float ox = q.rx;
    float oy = q.ry;
    if (q.id >= 0.f) {
      // A row's tile row is its tile's (dense_prep writes it so); the
      // clamp only keeps a malformed row inside the staged tiles.
      const int tcy = min(max((int)g.y, t0), t1 - 1);
      const int w0 = max(tcy - 1, 0);
      const int w1 = min(tcy + 1, ty - 1) + 1;
      int lo[3], hi[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int ck = c + k - 1;
        lo[k] = 0;
        hi[k] = 0;
        if (ck >= 0 && ck < tx) {
          const int s = staged ? shift[k] : 0;
          lo[k] = tile_start[ck * ty + w0] - s;
          hi[k] = tile_start[ck * ty + w1] - s;
        }
      }
      if (staged) {
        const Staged src{P, V};
        int n = 0;
        walk(q, src, lo, hi, [&](int j) {
          if (n < LIST_CAP) list[n * stride] = (unsigned short)j;
          ++n;
        });
        const bool over = n > LIST_CAP;
        if (over && overflow != nullptr) atomicAdd(overflow, 1);
        query_forces<INT_PRIO>(zp, neg_inv_fd, inv_mass, q, src, lo, hi,
                               list, stride, over ? -1 : n, ox, oy);
      } else {
        query_forces<INT_PRIO>(zp, neg_inv_fd, inv_mass, q, InPlace{rows4},
                               lo, hi, list, stride, -1, ox, oy);
      }
    }
    out2[(long long)c * col_cap + (row - cs)] = make_float2(ox, oy);
  }
}

template <bool INT_PRIO>
cudaError_t launch_dense(const float* zp5, const float* feat,
                         const int* tile_start, float* out, int* overflow,
                         int tx, int ty, int col_cap, int T, int threads,
                         int stage_rows, cudaStream_t stream) {
  static std::atomic<unsigned> configured{0};
  cudaError_t e = opt_in_shared_memory(
      reinterpret_cast<const void*>(zanlungo_dense_kernel<INT_PRIO>),
      configured);
  if (e != cudaSuccess) return e;
  const int runs = (ty + T - 1) / T;
  const size_t smem = dense_layout(stage_rows, threads).bytes;
  zanlungo_dense_kernel<INT_PRIO><<<tx * runs, threads, smem, stream>>>(
      zp5, feat, tile_start, out, overflow, tx, ty, col_cap, T, stage_rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace crowdsim

// The launch geometry is the caller's (ops/zanlungo_dense.py
// k4_geometry): T tile rows of one column a block, `threads` a block,
// `stage_rows` staged candidate rows.
extern "C" int crowdsim_zanlungo_dense(const float* zp5, const float* feat,
                                       const int* tile_start, float* out,
                                       int* overflow, int tx, int ty,
                                       int col_cap, int T, int threads,
                                       int stage_rows, int int_prio,
                                       void* stream) {
  if (threads < 32 || threads > crowdsim::MAX_THREADS || threads % 32 ||
      T < 1 || stage_rows < 1 || stage_rows > crowdsim::MAX_STAGE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      int_prio ? crowdsim::launch_dense<true>(zp5, feat, tile_start, out,
                                              overflow, tx, ty, col_cap, T,
                                              threads, stage_rows, s)
               : crowdsim::launch_dense<false>(zp5, feat, tile_start, out,
                                               overflow, tx, ty, col_cap, T,
                                               threads, stage_rows, s);
  return (int)e;
}
