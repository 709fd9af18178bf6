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
// sum of pair forces over the same set) applies only where t_i is finite.
// Dead query rows (id < 0) get their rec row; rows past the column's
// capacity are not written.
//
// Design: the standard GPU cell list.  One block per (column, run of 128
// rows of that column), one thread per query row; blocks past the
// column's length return at once.  Each thread knows its three candidate
// row ranges (contiguous, since rows are tile-sorted).  A warp walks the
// union of its lanes' ranges per column: each step loads one candidate
// row (32 bytes, the same address in every lane: one broadcast
// transaction through L1) and each lane tests it against its own range
// and the pair mask.  Rows of a warp are consecutive in a column and so
// span one or two tiles; the union is close to each lane's own range.
// Two passes: min TTC, then the force sum (only lanes with a finite t_i
// take part).  Exact for any window extent: a hotspot only makes the
// walk longer.
//
// Bound on the H100: work, not bytes.  At the 1M bench scene the rows
// (64 MB) are read about 4 times (mostly from L2); each of the 1M
// queries makes ~2 x 200 masked candidate tests, and the pair math runs
// on the ~9 true neighbours only.
#include <climits>

#include <cuda_runtime.h>

#include "zanlungo_pair.cuh"

namespace crowdsim {

constexpr int ROW_TCY = 13;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <bool INT_PRIO>
__global__ void zanlungo_dense_kernel(const float* __restrict__ zp5,
                                      const float* __restrict__ feat,
                                      const int* __restrict__ tile_start,
                                      float* __restrict__ out, int tx, int ty,
                                      int col_cap) {
  const int runs = (col_cap + blockDim.x - 1) / blockDim.x;
  const int c = blockIdx.x / runs;
  const int run0 = (blockIdx.x % runs) * blockDim.x;
  const int cs = tile_start[c * ty];
  const int len = min(tile_start[(c + 1) * ty] - cs, col_cap);
  if (run0 >= len) return;  // the whole block lies past the column's rows

  const int local = run0 + threadIdx.x;
  const bool in_col = local < len;
  const float* qrow = feat + (long long)(cs + (in_col ? local : 0)) * NUM_F;
  const Query q = load_query(qrow);
  const bool live = in_col && q.id >= 0.f;

  // Candidate row ranges [lo, hi) in columns c-1, c, c+1.
  int lo[3], hi[3];
  const int tcy = (int)qrow[ROW_TCY];
  const int t0 = max(tcy - 1, 0);
  const int t1 = min(tcy + 1, ty - 1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int ck = c + k - 1;
    if (live && ck >= 0 && ck < tx) {
      lo[k] = tile_start[ck * ty + t0];
      hi[k] = tile_start[ck * ty + t1 + 1];
    } else {
      lo[k] = INT_MAX;
      hi[k] = INT_MIN;
    }
  }

  const Params zp = load_params(zp5);
  const float4* rows4 = reinterpret_cast<const float4*>(feat);

  float t_i = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int wlo = __reduce_min_sync(FULL_MASK, lo[k]);
    const int whi = __reduce_max_sync(FULL_MASK, hi[k]);
    for (int j = wlo; j < whi; ++j) {
      const float4 a = __ldg(rows4 + (long long)j * (NUM_F / 4));  // px py vx vy
      const float cid = __ldg(feat + (long long)j * NUM_F + ROW_ID);
      if (j >= lo[k] && j < hi[k] && pair_mask(q, a.x, a.y, cid)) {
        t_i = fminf(t_i, pair_ttc(q, a.z, a.w, a.x, a.y, zp.agent_radius));
      }
    }
  }

  float ox = q.rx;
  float oy = q.ry;
  const bool pass2 = live && isfinite(t_i);
  if (__any_sync(FULL_MASK, pass2)) {
    const float inv_t = 1.f / (t_i > 0.f ? t_i : 1.f);
    const float neg_inv_fd = -1.f / zp.force_distance;
    float fx = 0.f;
    float fy = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int mlo = pass2 ? lo[k] : INT_MAX;
      const int mhi = pass2 ? hi[k] : INT_MIN;
      const int wlo = __reduce_min_sync(FULL_MASK, mlo);
      const int whi = __reduce_max_sync(FULL_MASK, mhi);
      for (int j = wlo; j < whi; ++j) {
        const float4 a = __ldg(rows4 + (long long)j * (NUM_F / 4));
        const float4 b = __ldg(rows4 + (long long)j * (NUM_F / 4) + 1);
        // b = fx fy prio id
        if (j >= mlo && j < mhi && pair_mask(q, a.x, a.y, b.w)) {
          pair_force<INT_PRIO>(zp, t_i, inv_t, neg_inv_fd, q, a.x, a.y, a.z,
                               a.w, b.x, b.y, b.z, fx, fy);
        }
      }
    }
    if (pass2) {
      const float inv_mass = 1.f / zp.agent_mass;
      ox = q.rx + fx * inv_mass;
      oy = q.ry + fy * inv_mass;
    }
  }
  if (in_col) {
    float* o = out + ((long long)c * col_cap + local) * 2;
    o[0] = ox;
    o[1] = oy;
  }
}

template <bool INT_PRIO>
static cudaError_t launch_dense(const float* zp5, const float* feat,
                                const int* tile_start, float* out, int tx,
                                int ty, int col_cap, int rows_per_block,
                                cudaStream_t stream) {
  const int runs = (col_cap + rows_per_block - 1) / rows_per_block;
  zanlungo_dense_kernel<INT_PRIO><<<tx * runs, rows_per_block, 0, stream>>>(
      zp5, feat, tile_start, out, tx, ty, col_cap);
  return cudaGetLastError();
}

}  // namespace crowdsim

extern "C" int crowdsim_zanlungo_dense(const float* zp5, const float* feat,
                                       const int* tile_start, float* out,
                                       int tx, int ty, int col_cap,
                                       int rows_per_block, int int_prio,
                                       void* stream) {
  // Whole warps only: the warp-wide range reductions need every lane.
  if (rows_per_block <= 0 || rows_per_block > 1024 || rows_per_block % 32)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      int_prio ? crowdsim::launch_dense<true>(zp5, feat, tile_start, out, tx,
                                              ty, col_cap, rows_per_block, s)
               : crowdsim::launch_dense<false>(zp5, feat, tile_start, out,
                                               tx, ty, col_cap,
                                               rows_per_block, s);
  return (int)e;
}
