// K2: per-spill window recompute for the exact bucket-overflow repair.
//
// Replaces the TPU kernel rmf_crowdsim_tpu/ops/zanlungo_pallas.py:
// _spill_groups_window_pallas / _make_spill_kernel (Pallas, one program
// per spill, five 128-aligned candidate DMAs rolled into place).
//
// Contract (ops/spill.py): for spill p with (carried or fresh) tile
// (tcx, tcy), the 5x5 tile window is clamped into the world
// (bx = clamp(tcx-2, 0, tx-5), by likewise) and the 3x3 query block
// (clamp(tcx-1, 0, tx-3), ...) lies inside it.  Query q = 3*b*i + b*j + r
// is slot r of tile (qcol + i, qrow + j); its candidates are the window's
// 5 column runs of 5*bucket slots followed by the spill list, masked like
// K1 (strict d^2 < eye^2, another id, live candidate and query).
// out[p, q] = rec + F/m as in K1.  Queries with id < 0 get their rec row;
// the block of an invalid spill (id < 0 in the spill list) returns at
// once and leaves its rows unwritten (callers mask them out).
//
// Design.  One block per spill slot, 9*bucket threads (one query each).
// The block stages the window's 25*bucket candidate slots and the whole
// spill list (8 features each) in shared memory: (800 + S) * 32 bytes,
// 34 KB at bucket 32 and S = 244; above 48 KB the launch raises the
// dynamic shared-memory limit (up to the H100's 227 KB per block, about
// S = 6,400).  Every thread then makes the two passes of K1 over all
// candidates.
//
// Bound on the H100: launch latency and the serial pass per block.  The
// grid is small (S = n / 4096 blocks at the bench scene) and most blocks
// are invalid and exit at once; a live block's work is 288 queries x
// ~1,000 candidates x 2 passes of mask tests.  The single launch over all
// S slots (no spill-count tiers, no host read of the spill count) is what
// the design buys: the step never waits on the host for it.
#include <cuda_runtime.h>

#include "zanlungo_pair.cuh"

namespace crowdsim {

template <bool INT_PRIO>
__global__ void spill_window_kernel(const float* __restrict__ zp5,
                                    const float* __restrict__ packed_t,
                                    const float* __restrict__ packed_T,
                                    const float* __restrict__ sp_T,
                                    const int* __restrict__ sp_tcx,
                                    const int* __restrict__ sp_tcy,
                                    float* __restrict__ out, int n_spill,
                                    int tx, int ty, int bucket) {
  const int p = blockIdx.x;
  if (sp_T[ROW_ID * n_spill + p] < 0.f) return;  // invalid spill slot

  extern __shared__ float cand[];  // [NUM_CAND][CW]
  const long long slots = (long long)tx * ty * bucket;
  const int run = 5 * bucket;
  const int n_win = 5 * run;
  const int CW = n_win + n_spill;
  const int tcx = sp_tcx[p];
  const int tcy = sp_tcy[p];
  const int bx = min(max(tcx - 2, 0), tx - 5);
  const int by = min(max(tcy - 2, 0), ty - 5);

  for (int i = threadIdx.x; i < n_win; i += blockDim.x) {
    const int k = i / run;
    const long long s =
        ((long long)(bx + k) * ty + by) * bucket + (i - k * run);
    for (int f = 0; f < NUM_CAND; ++f)
      cand[f * CW + i] = packed_T[f * slots + s];
  }
  for (int i = threadIdx.x; i < n_spill; i += blockDim.x) {
    for (int f = 0; f < NUM_CAND; ++f)
      cand[f * CW + n_win + i] = sp_T[f * n_spill + i];
  }
  __syncthreads();

  const int qb = 3 * bucket;
  const int i = threadIdx.x / qb;
  const int j = (threadIdx.x - i * qb) / bucket;
  const int r = threadIdx.x % bucket;
  const int qcol = min(max(tcx - 1, 0), tx - 3) + i;
  const int qrow = min(max(tcy - 1, 0), ty - 3) + j;
  const long long qs = ((long long)qcol * ty + qrow) * bucket + r;
  const Query q = load_query(packed_t + qs * NUM_F);

  float ox = q.rx;
  float oy = q.ry;
  if (q.id >= 0.f) {
    const Params zp = load_params(zp5);
    const float* px = cand + ROW_PX * CW;
    const float* py = cand + ROW_PY * CW;
    const float* vx = cand + ROW_VX * CW;
    const float* vy = cand + ROW_VY * CW;
    const float* id = cand + ROW_ID * CW;
    float t_i = CUDART_INF_F;
    for (int c = 0; c < CW; ++c) {
      if (pair_mask(q, px[c], py[c], id[c])) {
        t_i = fminf(t_i, pair_ttc(q, vx[c], vy[c], px[c], py[c],
                                  zp.agent_radius));
      }
    }
    if (isfinite(t_i)) {
      const float inv_t = 1.f / (t_i > 0.f ? t_i : 1.f);
      const float neg_inv_fd = -1.f / zp.force_distance;
      const float* fxr = cand + ROW_FX * CW;
      const float* fyr = cand + ROW_FY * CW;
      const float* pr = cand + ROW_PRIO * CW;
      float fx = 0.f;
      float fy = 0.f;
      for (int c = 0; c < CW; ++c) {
        if (pair_mask(q, px[c], py[c], id[c])) {
          pair_force<INT_PRIO>(zp, t_i, inv_t, neg_inv_fd, q, px[c], py[c],
                               vx[c], vy[c], fxr[c], fyr[c], pr[c], fx, fy);
        }
      }
      const float inv_mass = 1.f / zp.agent_mass;
      ox = q.rx + fx * inv_mass;
      oy = q.ry + fy * inv_mass;
    }
  }
  float* o = out + ((long long)p * 9 * bucket + threadIdx.x) * 2;
  o[0] = ox;
  o[1] = oy;
}

template <bool INT_PRIO>
static cudaError_t launch_spill(const float* zp5, const float* packed_t,
                                const float* packed_T, const float* sp_T,
                                const int* sp_tcx, const int* sp_tcy,
                                float* out, int n_spill, int tx, int ty,
                                int bucket, cudaStream_t stream) {
  const size_t smem = sizeof(float) * NUM_CAND * (25 * bucket + n_spill);
  auto kernel = spill_window_kernel<INT_PRIO>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<n_spill, 9 * bucket, smem, stream>>>(zp5, packed_t, packed_T,
                                                 sp_T, sp_tcx, sp_tcy, out,
                                                 n_spill, tx, ty, bucket);
  return cudaGetLastError();
}

}  // namespace crowdsim

extern "C" int crowdsim_spill_window(const float* zp5, const float* packed_t,
                                     const float* packed_T, const float* sp_T,
                                     const int* sp_tcx, const int* sp_tcy,
                                     float* out, int n_spill, int tx, int ty,
                                     int bucket, int int_prio, void* stream) {
  if (9 * bucket > 1024 || tx < 5 || ty < 5)
    return (int)cudaErrorInvalidConfiguration;
  if (n_spill <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      int_prio ? crowdsim::launch_spill<true>(zp5, packed_t, packed_T, sp_T,
                                              sp_tcx, sp_tcy, out, n_spill,
                                              tx, ty, bucket, s)
               : crowdsim::launch_spill<false>(zp5, packed_t, packed_T, sp_T,
                                               sp_tcx, sp_tcy, out, n_spill,
                                               tx, ty, bucket, s);
  return (int)e;
}
