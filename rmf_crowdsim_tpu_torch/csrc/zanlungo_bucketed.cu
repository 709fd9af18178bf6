// K1: fused neighbour search + Zanlungo force over the bucketed plane,
// and K1b: the same with the fused-spill candidate segment.
//
// Replaces the TPU kernel rmf_crowdsim_tpu/ops/zanlungo_pallas.py:
// zanlungo_forces_bucketed / _make_kernel (Pallas, one program per column
// strip with strip-resident VMEM windows and one-hot MXU compaction); K1b
// replaces its spill_ext variant (zanlungo_pallas.py:1365-1437, the
// fourth segment at :1301-1314).
//
// Contract (ops/zanlungo_bucketed.py): for every live slot (id >= 0),
// out = rec + F / m, where t_i is the minimum time to collision over the
// live candidates in the 3x3 tiles around the query's tile with strict
// d^2 < eye^2 and another id, and F (the sum of pair forces over the same
// set) applies only where t_i is finite.  Empty slots get their rec row.
// K1b: a query whose sub-block (tiles tcy / sub_tiles of its column, the
// JAX sub-block index) has a nonzero sflag also takes the live lanes of
// the spill plane sp_T [NUM_CAND, n_sp] as candidates, in both passes,
// after the window; other queries run K1's exact instruction sequence.
//
// Design.  One block per run of T tiles of one tile column, one thread
// per query slot (T * bucket threads).  The block stages the 8 candidate
// feature rows of columns tcx-1..tcx+1 over tiles tcy0-1..tcy0+T in shared
// memory (3 * (T+2) * bucket * 32 bytes, ~30 KB at T = 8, bucket 32),
// clipped at the world's edges (clipped slots read as sentinels, never as
// the neighbouring column).  Each thread then makes two passes over its
// 9 * bucket candidates, read from shared memory as warp-wide broadcasts:
// the min TTC, then the force sum.  A block whose tiles hold no live
// agent writes rec and returns before staging.  K1b stages the spill plane
// (4 KB at n_sp = 128) behind the window, only in blocks that hold a
// flagged live query.
//
// Bound on the H100: work, not bytes.  At the 1M bench scene the kernel
// reads the 59 MB candidate plane ~3.75 times (halo re-reads, mostly from
// L2) and the 117 MB query plane once, ~0.1 ms of HBM time, but runs
// ~1.8M queries x 288 candidates x 2 passes of mask tests plus the full
// pair math on the ~9 true neighbours of each query: instruction-rate
// bound.  The design keeps every candidate read in shared memory and does
// the pair math only behind the mask; fewer mask tests (sorting
// candidates within a tile, or a cell list finer than the tile) are work
// for later.  K1b adds 2 x n_sp mask tests to the few flagged queries.
#include <cuda_runtime.h>

#include "zanlungo_pair.cuh"

namespace crowdsim {

template <bool INT_PRIO, bool SPILL>
__global__ void zanlungo_bucketed_kernel(const float* __restrict__ zp5,
                                         const float* __restrict__ packed_t,
                                         const float* __restrict__ packed_T,
                                         const int* __restrict__ sflag,
                                         const float* __restrict__ sp_T,
                                         float* __restrict__ out, int tx,
                                         int ty, int bucket, int T,
                                         int sub_tiles, int n_sp) {
  // [NUM_CAND][3][W]; K1b: then [NUM_CAND][n_sp].
  extern __shared__ float stage[];
  const long long slots = (long long)tx * ty * bucket;
  const int runs = (ty + T - 1) / T;
  const int tcx = blockIdx.x / runs;
  const int tcy0 = (blockIdx.x % runs) * T;
  const int W = (T + 2) * bucket;
  const int lt = threadIdx.x / bucket;
  const int tcy = tcy0 + lt;
  const bool in_world = tcy < ty;
  const long long qs =
      ((long long)tcx * ty + tcy) * bucket + threadIdx.x % bucket;

  const float* qrow = packed_t + qs * NUM_F;
  const float qid = in_world ? qrow[ROW_ID] : -1.f;
  const bool live = qid >= 0.f;
  if (!__syncthreads_or(live)) {
    if (in_world) {
      out[2 * qs] = qrow[ROW_RX];
      out[2 * qs + 1] = qrow[ROW_RY];
    }
    return;
  }

  for (int i = threadIdx.x; i < 3 * W; i += blockDim.x) {
    const int k = i / W;
    const int j = i - k * W;
    const int c = tcx + k - 1;
    const int tile = tcy0 - 1 + j / bucket;
    const bool ok = c >= 0 && c < tx && tile >= 0 && tile < ty;
    const long long s = ((long long)c * ty + tile) * bucket + j % bucket;
    for (int f = 0; f < NUM_CAND; ++f) {
      stage[(f * 3 + k) * W + j] =
          ok ? packed_T[f * slots + s] : sentinel_feature(f);
    }
  }
  // K1b: the query's sub-block flag, and the spill plane where needed.
  bool flagged = false;
  float* sp = stage + NUM_CAND * 3 * W;
  if (SPILL) {
    flagged =
        in_world && sflag[tcx * (ty / sub_tiles) + tcy / sub_tiles] > 0;
    if (__syncthreads_or(live && flagged)) {
      for (int i = threadIdx.x; i < NUM_CAND * n_sp; i += blockDim.x)
        sp[i] = sp_T[i];
    }
  }
  __syncthreads();
  if (!in_world) return;

  const Query q = load_query(qrow);
  float ox = q.rx;
  float oy = q.ry;
  if (live) {
    const Params zp = load_params(zp5);
    // Staged tile index of tile tcy + dy is lt + 1 + dy; rows past the
    // world's top or bottom are skipped (they hold sentinels anyway).
    const int dy_lo = tcy > 0 ? -1 : 0;
    const int dy_hi = tcy < ty - 1 ? 1 : 0;
    const int j_lo = (lt + 1 + dy_lo) * bucket;
    const int j_hi = (lt + 2 + dy_hi) * bucket;

    float t_i = CUDART_INF_F;
    for (int k = 0; k < 3; ++k) {
      const float* px = stage + (ROW_PX * 3 + k) * W;
      const float* py = stage + (ROW_PY * 3 + k) * W;
      const float* vx = stage + (ROW_VX * 3 + k) * W;
      const float* vy = stage + (ROW_VY * 3 + k) * W;
      const float* id = stage + (ROW_ID * 3 + k) * W;
      for (int j = j_lo; j < j_hi; ++j) {
        if (pair_mask(q, px[j], py[j], id[j])) {
          t_i = fminf(t_i, pair_ttc(q, vx[j], vy[j], px[j], py[j],
                                    zp.agent_radius));
        }
      }
    }
    if (SPILL && flagged) {
      const float* px = sp + ROW_PX * n_sp;
      const float* py = sp + ROW_PY * n_sp;
      const float* vx = sp + ROW_VX * n_sp;
      const float* vy = sp + ROW_VY * n_sp;
      const float* id = sp + ROW_ID * n_sp;
      for (int j = 0; j < n_sp; ++j) {
        if (pair_mask(q, px[j], py[j], id[j])) {
          t_i = fminf(t_i, pair_ttc(q, vx[j], vy[j], px[j], py[j],
                                    zp.agent_radius));
        }
      }
    }

    if (isfinite(t_i)) {
      const float inv_t = 1.f / (t_i > 0.f ? t_i : 1.f);
      const float neg_inv_fd = -1.f / zp.force_distance;
      float fx = 0.f;
      float fy = 0.f;
      for (int k = 0; k < 3; ++k) {
        const float* px = stage + (ROW_PX * 3 + k) * W;
        const float* py = stage + (ROW_PY * 3 + k) * W;
        const float* vx = stage + (ROW_VX * 3 + k) * W;
        const float* vy = stage + (ROW_VY * 3 + k) * W;
        const float* fxr = stage + (ROW_FX * 3 + k) * W;
        const float* fyr = stage + (ROW_FY * 3 + k) * W;
        const float* pr = stage + (ROW_PRIO * 3 + k) * W;
        const float* id = stage + (ROW_ID * 3 + k) * W;
        for (int j = j_lo; j < j_hi; ++j) {
          if (pair_mask(q, px[j], py[j], id[j])) {
            pair_force<INT_PRIO>(zp, t_i, inv_t, neg_inv_fd, q, px[j], py[j],
                                 vx[j], vy[j], fxr[j], fyr[j], pr[j], fx,
                                 fy);
          }
        }
      }
      if (SPILL && flagged) {
        const float* px = sp + ROW_PX * n_sp;
        const float* py = sp + ROW_PY * n_sp;
        const float* vx = sp + ROW_VX * n_sp;
        const float* vy = sp + ROW_VY * n_sp;
        const float* fxr = sp + ROW_FX * n_sp;
        const float* fyr = sp + ROW_FY * n_sp;
        const float* pr = sp + ROW_PRIO * n_sp;
        const float* id = sp + ROW_ID * n_sp;
        for (int j = 0; j < n_sp; ++j) {
          if (pair_mask(q, px[j], py[j], id[j])) {
            pair_force<INT_PRIO>(zp, t_i, inv_t, neg_inv_fd, q, px[j], py[j],
                                 vx[j], vy[j], fxr[j], fyr[j], pr[j], fx,
                                 fy);
          }
        }
      }
      const float inv_mass = 1.f / zp.agent_mass;
      ox = q.rx + fx * inv_mass;
      oy = q.ry + fy * inv_mass;
    }
  }
  out[2 * qs] = ox;
  out[2 * qs + 1] = oy;
}

template <bool INT_PRIO, bool SPILL>
static cudaError_t launch(const float* zp5, const float* packed_t,
                          const float* packed_T, const int* sflag,
                          const float* sp_T, float* out, int tx, int ty,
                          int bucket, int T, int sub_tiles, int n_sp,
                          cudaStream_t stream) {
  const int runs = (ty + T - 1) / T;
  const size_t smem =
      sizeof(float) * NUM_CAND * (3 * (T + 2) * bucket + (SPILL ? n_sp : 0));
  auto kernel = zanlungo_bucketed_kernel<INT_PRIO, SPILL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<tx * runs, T * bucket, smem, stream>>>(
      zp5, packed_t, packed_T, sflag, sp_T, out, tx, ty, bucket, T,
      sub_tiles, n_sp);
  return cudaGetLastError();
}

// Tiles per block: blocks of more than 1024 threads cannot launch, so
// shrink the run.
static int run_tiles(int tiles_per_block, int bucket) {
  int T = tiles_per_block;
  while (T > 1 && T * bucket > 1024) --T;
  return T;
}

}  // namespace crowdsim

extern "C" int crowdsim_zanlungo_bucketed(const float* zp5,
                                          const float* packed_t,
                                          const float* packed_T, float* out,
                                          int tx, int ty, int bucket,
                                          int tiles_per_block, int int_prio,
                                          void* stream) {
  const int T = crowdsim::run_tiles(tiles_per_block, bucket);
  if (T * bucket > 1024) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      int_prio ? crowdsim::launch<true, false>(zp5, packed_t, packed_T,
                                               nullptr, nullptr, out, tx, ty,
                                               bucket, T, 1, 0, s)
               : crowdsim::launch<false, false>(zp5, packed_t, packed_T,
                                                nullptr, nullptr, out, tx, ty,
                                                bucket, T, 1, 0, s);
  return (int)e;
}

extern "C" int crowdsim_zanlungo_bucketed_spill(
    const float* zp5, const float* packed_t, const float* packed_T,
    const int* sflag, const float* sp_T, float* out, int tx, int ty,
    int bucket, int tiles_per_block, int sub_tiles, int n_sp, int int_prio,
    void* stream) {
  const int T = crowdsim::run_tiles(tiles_per_block, bucket);
  if (T * bucket > 1024 || sub_tiles <= 0 || ty % sub_tiles || n_sp <= 0)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      int_prio ? crowdsim::launch<true, true>(zp5, packed_t, packed_T, sflag,
                                              sp_T, out, tx, ty, bucket, T,
                                              sub_tiles, n_sp, s)
               : crowdsim::launch<false, true>(zp5, packed_t, packed_T, sflag,
                                               sp_T, out, tx, ty, bucket, T,
                                               sub_tiles, n_sp, s);
  return (int)e;
}

extern "C" const char* crowdsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
