// K2: the exact repair of bucket overflow, in one launch: each spill's
// window queries, its own row, and the write of the affected rows.
//
// Replaces the TPU kernel rmf_crowdsim_tpu/ops/zanlungo_pallas.py:
// _spill_groups_window_pallas / _make_spill_kernel (Pallas, one program
// per spill, five 128-aligned candidate DMAs rolled into place), with the
// two passes the JAX package runs around it: the spills' own rows
// (_spill_own_rows, :1936) and the write of the affected rows (spill_patch,
// :1538-1583).
//
// Contract (ops/spill.py spill_window), per live spill p (rows[p] in the
// packed-row layout, id = its agent index; invalid slots have id -1) with
// (carried or fresh) tile (tcx, tcy).  The 3x3 query block is clamped into
// the world: columns qcol .. qcol+2, qcol = clamp(tcx-1, 0, tx-3), rows
// likewise; the 5x5 window (bx = clamp(tcx-2, 0, tx-5), ...) holds it.
//   - Window query q = 3b*i + b*j + r, slot r of tile (qcol+i, qrow+j):
//     out[p, q] = rec + F/m over the live candidates of the window and the
//     spill list with strict d^2 < eye^2 and another id, walked window
//     column by window column, each column's slots in order, then the
//     list; F applies only where the minimum time to collision is finite.
//     An empty query slot gets its rec row.
//   - Own row: out[p, 9b] likewise for the query rows[p], over the 9b
//     slots of the query block, column by column, then the spill list,
//     in the models/local.py math (zanlungo_from_rows, as the JAX
//     package's _spill_own_rows keeps it): oracle_ttc and oracle_force
//     below follow it operation for operation.
//   - The write: where `windows` is null or true, a live window query q
//     with d^2(q, spill p) < eye_q^2 is written to vel[id of q]; the own
//     row is written to vel[id of p].  vel is float or double.
// Where `windows` is false only the own rows are computed and written;
// the window rows of `out` are left as they were.  Invalid spills' rows
// of `out` are not written.
//
// Exactness of the walk.  tile_size >= max eyesight (and on a carried
// binning, the skin bound that keeps K1 exact) means a candidate the mask
// takes lies in the query's own 3x3 tiles, and those tiles, where they
// are in the world, lie inside the window.  So a window query walks only
// its own 3x3 tiles plus the spill list, in the contract's order: it
// skips only candidates that the mask rejects, and does the same float
// operations as the full walk, bit for bit (-fmad=false).  The walk no
// longer depends on which spill's window the query sits in, so blocks of
// several spills that write the same agent write the same bits: the
// overlapping windows need no dedup (the JAX docstring's idempotence,
// zanlungo_pallas.py:1461-1463).
//
// Bound on the H100: launch latency.  At the 1M bench scene (62 live
// spills in 244 slots) the bytes its inputs need and its f32 operations
// take ~1 us (utils/roofline.py k2_bytes, k2_work), below the latency of
// one launch.  The first design (one block per spill slot, one thread
// per query slot, every thread testing all 25b + S staged slots twice)
// ran 0.16 ms.  This design takes K1's answers (neighbour_list.cuh):
//   1. Three blocks a spill, one per query column i, so ~3 x 62 blocks
//      share the 132 SMs; an invalid spill's blocks exit before staging,
//      and with windows off only the own-row block (i = 1) runs.
//   2. Block (p, i) stages window rows by .. by+4 of columns c-1 .. c+1
//      (c = qcol + i; columns outside the world hold nothing) and then
//      the spill list, the live entries compacted in order (ballot words
//      and a prefix): each query's tiles are three contiguous ranges and
//      the live spills a fourth.  The own-row block's columns are exactly
//      the query block's.
//   3. The block has 256 threads (at bucket 32), so each staging pass
//      takes three rounds of global loads; the first 3 bucket threads
//      take the column's live queries (warp-aggregated): one mask
//      pass into a 32-entry list, the TTC and force passes over it, an
//      exact re-walk past 32 hits (counted in the optional `overflow`).
//      In block i = 1 the last warp takes the own row meanwhile, its lanes
//      splitting the candidates and adding the hits' forces in candidate
//      order (oracle_velocity): one thread walking ~220 candidates twice
//      with the oracle math took ~40 us on an H100.
//   4. The rows are written in place: no host read of the spill count and
//      no pass outside the kernel.
//
// Shared memory (spill_layout): the stage as two float4 arrays
// [15 bucket + S]; the ballot words and their prefix; the lists
// [LIST_CAP][query threads] uint16; the live query slots [3 bucket]
// uint16; one counter.  29,712 bytes at bucket 32 and S = 244; above 48 KB
// the kernel opts into the SM's whole shared memory, which holds S up to
// ~6,500.
#include <atomic>

#include <cuda_runtime.h>

#include "neighbour_list.cuh"
#include "smem.cuh"
#include "zanlungo_pair.cuh"

namespace crowdsim {
namespace {

constexpr int MAX_THREADS = 512;

struct SpillLayout {
  int cols;    // staged window slots: 3 columns x 5 tiles x bucket
  int row;     // staged entries: cols + n_spill
  int chunks;  // ballot words, ceil(row / 32)
  size_t stage_off, ballot_off, prefix_off, list_off, qslot_off, count_off;
  size_t bytes;
};

// Threads that take window queries: the column's 3 bucket slots, rounded
// up to a warp.
__host__ __device__ __forceinline__ int query_threads(int bucket) {
  return (3 * bucket + 31) / 32 * 32;
}

// A block: the query threads, one more warp for the own row, and at least
// 256 threads, so the staging loops take few rounds of global loads.
__host__ __device__ __forceinline__ int spill_threads(int bucket) {
  return max(256, query_threads(bucket) + 32);
}

__host__ __device__ __forceinline__ SpillLayout spill_layout(int bucket,
                                                             int n_spill) {
  SpillLayout L;
  L.cols = 15 * bucket;
  L.row = L.cols + n_spill;
  L.chunks = (L.row + 31) / 32;
  size_t o = 0;
  L.stage_off = o;
  o = align16(o + 2 * sizeof(float4) * L.row);
  L.ballot_off = o;
  o = align16(o + sizeof(unsigned) * L.chunks);
  L.prefix_off = o;
  o = align16(o + sizeof(int) * (L.chunks + 1));
  L.list_off = o;
  o = align16(o + sizeof(unsigned short) * LIST_CAP * query_threads(bucket));
  L.qslot_off = o;
  o = align16(o + sizeof(unsigned short) * 3 * bucket);
  L.count_off = o;
  L.bytes = align16(o + sizeof(int));
  return L;
}

// Time to collision in the models/local.py form (time_to_collision:
// full b, both roots divided by 2a).
__device__ __forceinline__ float oracle_ttc(const Query& q, float cvx,
                                            float cvy, float cpx, float cpy,
                                            float radius) {
  const float rvx = cvx - q.vx;
  const float rvy = cvy - q.vy;
  const float rpx = cpx - q.px;
  const float rpy = cpy - q.py;
  const float a = rvx * rvx + rvy * rvy;
  const float b = 2.f * (rvx * rpx + rvy * rpy);
  const float c = (rpx * rpx + rpy * rpy) - radius * radius;
  const float disc = b * b - 4.f * a * c;
  if (!(a > 0.f) || disc < 0.f) return CUDART_INF_F;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float t0 = (-b - sq) / (2.f * a);
  const float t1 = (-b + sq) / (2.f * a);
  if ((t0 < 0.f && t1 > 0.f) || (t1 < 0.f && t0 > 0.f)) return 0.f;
  if (t0 < t1 && t0 > 0.f) return t0;
  return t1 > 0.f ? t1 : CUDART_INF_F;
}

// One pair's force in the models/local.py form (zanlungo_from_rows: the
// reference's slerp, a division wherever it divides), added into (fx, fy),
// for a pair the caller has masked in, with finite t_i.
__device__ __forceinline__ void oracle_force(const Params& zp, float t_i,
                                             const Query& q, float cpx,
                                             float cpy, float cvx, float cvy,
                                             float cfx, float cfy,
                                             float cprio, float& fx,
                                             float& fy) {
  const float row = fminf(fmaxf(q.prio - cprio, -1.f), 1.f);
  const float r2n = sqrtf(fmaxf(-row, 0.f));
  const float r2p = sqrtf(fmaxf(row, 0.f));
  const float w = row < 0.f ? -r2n : (row > 0.f ? r2p : 0.f);
  const float mvx = row > 0.f ? q.vx + r2p * (q.spx - q.vx) : q.vx;
  const float mvy = row > 0.f ? q.vy + r2p * (q.spy - q.vy) : q.vy;
  const float ovx = row < 0.f ? cvx + r2n * (cfx - cvx) : cvx;
  const float ovy = row < 0.f ? cvy + r2n * (cfy - cvy) : cvy;

  const float weight = 1.f - w;
  float dx = (q.px + mvx * t_i) - (cpx + ovx * t_i);
  float dy = (q.py + mvy * t_i) - (cpy + ovy * t_i);
  const float dist = sqrtf(dx * dx + dy * dy);

  const bool stationary = sqrtf(cfx * cfx + cfy * cfy) < 1e-4f;
  float psx = -(q.py - cpy);
  float psy = q.px - cpx;
  if (psx * q.vx + psy * q.vy < 0.f) {
    psx = -psx;
    psy = -psy;
  }
  float pmx = -cfy;
  float pmy = cfx;
  if (pmx * dx + pmy * dy < 0.f) {
    pmx = -pmx;
    pmy = -pmy;
  }
  const bool interpolate = stationary || (cfx * dx + cfy * dy > 0.f);
  const float perp_x = stationary ? psx : pmx;
  const float perp_y = stationary ? psy : pmy;
  const float sin_theta = fminf(fabsf(perp_x * dy - perp_y * dx), 1.f);
  if (weight > 1.f && interpolate && sin_theta > 0.f) {
    const float theta = asinf(sin_theta);
    const float t = weight - 1.f;
    const float s0 = sinf((1.f - t) * theta) / sin_theta;
    const float s1 = sinf(t * theta) / sin_theta;
    const float ndx = dx * s0 + perp_x * s1;
    const float ndy = dy * s0 + perp_y * s1;
    dx = ndx;
    dy = ndy;
  }
  const float d_norm = sqrtf(dx * dx + dy * dy);
  const float ux = d_norm > 0.f ? dx / d_norm : 0.f;
  const float uy = d_norm > 0.f ? dy / d_norm : 0.f;

  const float surface_dist = dist - 2.f * zp.agent_radius;
  const float sdx = mvx - ovx;
  const float sdy = mvy - ovy;
  const float speed_diff = sqrtf(sdx * sdx + sdy * sdy);
  const float safe_t = t_i > 0.f ? t_i : 1.f;
  float magnitude = weight * zp.agent_scale * speed_diff / safe_t;
  if (t_i == 0.f && speed_diff * weight > 0.f) magnitude = CUDART_INF_F;
  magnitude = fminf(magnitude, zp.force_cap);
  const float falloff = expf(-surface_dist / zp.force_distance);
  const float scale = magnitude * falloff;
  fx += ux * scale;
  fy += uy * scale;
}

// rec + F / m of the own-row query q in the models/local.py math, over
// the candidates of its ranges that its mask takes; run by one whole warp.
// The minimum time to collision: lane l takes every 32nd candidate of the
// ranges from the l-th on, then a minimum across the lanes (order-free).
// The forces: the lanes compute 32 consecutive candidates at a time, and
// the hits' forces are added in candidate order, one shuffle each, so the
// sum is a single walk's, bit for bit, wherever the candidates sit in the
// stage.  The world engine needs that: its spill list holds a shard's
// spills and its neighbours', so a spill's candidates sit at other stage
// places on D shards than on one.
__device__ __forceinline__ float2 oracle_velocity(const Query& q,
                                                  const Params& zp,
                                                  const float4* P,
                                                  const float4* V,
                                                  const int (&lo)[4],
                                                  const int (&hi)[4]) {
  const int lane = threadIdx.x & 31;
  float t_i = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    for (int j = lo[k] + lane; j < hi[k]; j += 32) {
      const float4 p = P[j];
      if (pair_mask(q, p.x, p.y, p.z)) {
        const float4 v = V[j];
        t_i = fminf(t_i, oracle_ttc(q, v.x, v.y, p.x, p.y, zp.agent_radius));
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    t_i = fminf(t_i, __shfl_xor_sync(FULL_MASK, t_i, d));
  float2 o = make_float2(q.rx, q.ry);
  if (isfinite(t_i)) {
    float fx = 0.f;
    float fy = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      for (int base = lo[k]; base < hi[k]; base += 32) {
        const int j = base + lane;
        float cfx = 0.f;
        float cfy = 0.f;
        bool hit = false;
        if (j < hi[k]) {
          const float4 p = P[j];
          if (pair_mask(q, p.x, p.y, p.z)) {
            const float4 v = V[j];
            oracle_force(zp, t_i, q, p.x, p.y, v.x, v.y, v.z, v.w, p.w, cfx,
                         cfy);
            hit = true;
          }
        }
        for (unsigned b = __ballot_sync(FULL_MASK, hit); b; b &= b - 1) {
          const int src = __ffs(b) - 1;
          fx += __shfl_sync(FULL_MASK, cfx, src);
          fy += __shfl_sync(FULL_MASK, cfy, src);
        }
      }
    }
    o.x = q.rx + fx / zp.agent_mass;
    o.y = q.ry + fy / zp.agent_mass;
  }
  return o;
}

template <bool INT_PRIO, class VelT>
__global__ void __launch_bounds__(MAX_THREADS)
    spill_window_kernel(const float* __restrict__ zp5,
                        const float* __restrict__ packed_t,
                        const float* __restrict__ packed_T,
                        const float* __restrict__ rows,
                        const int* __restrict__ sp_tcx,
                        const int* __restrict__ sp_tcy,
                        const unsigned char* __restrict__ windows,
                        float* __restrict__ out, VelT* __restrict__ vel,
                        int* __restrict__ overflow, int n_spill, int tx,
                        int ty, int bucket) {
  const int p = blockIdx.x / 3;
  const int i = blockIdx.x - 3 * p;  // the block's query column
  const float* own = rows + (long long)p * NUM_F;
  if (own[ROW_ID] < 0.f) return;  // invalid spill slot
  const bool win = windows == nullptr || *windows != 0;
  const bool own_row = i == 1;
  if (!win && !own_row) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const SpillLayout L = spill_layout(bucket, n_spill);
  float4* P = reinterpret_cast<float4*>(smem + L.stage_off);
  float4* V = P + L.row;
  unsigned* ballots = reinterpret_cast<unsigned*>(smem + L.ballot_off);
  int* prefix = reinterpret_cast<int*>(smem + L.prefix_off);
  unsigned short* lists =
      reinterpret_cast<unsigned short*>(smem + L.list_off);
  unsigned short* qslot =
      reinterpret_cast<unsigned short*>(smem + L.qslot_off);
  int* n_live = reinterpret_cast<int*>(smem + L.count_off);

  const long long slots = (long long)tx * ty * bucket;
  const int tcx = sp_tcx[p];
  const int tcy = sp_tcy[p];
  const int by = min(max(tcy - 2, 0), ty - 5);
  const int qcol = min(max(tcx - 1, 0), tx - 3);
  const int qrow = min(max(tcy - 1, 0), ty - 3);
  const int c = qcol + i;
  const int qb = 3 * bucket;  // query slots of the column
  const int W = 5 * bucket;   // staged slots of one column
  const long long qs0 = ((long long)c * ty + qrow) * bucket;
  const long long out0 = (long long)p * (9 * bucket + 1);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) *n_live = 0;
  __syncthreads();

  // 1. Queries: the column's empty slots get their rec row, live ones are
  //    listed in slot order within a warp.
  if (win) {
    for (int base = 0; base < qb; base += blockDim.x) {
      const int l = base + threadIdx.x;
      const bool in = l < qb;
      const long long s = qs0 + l;
      const bool live = in && packed_T[ROW_ID * slots + s] >= 0.f;
      if (in && !live) {
        float* o = out + 2 * (out0 + i * qb + l);
        o[0] = packed_t[s * NUM_F + ROW_RX];
        o[1] = packed_t[s * NUM_F + ROW_RY];
      }
      const unsigned bal = __ballot_sync(FULL_MASK, live);
      int first = 0;
      if (lane == 0 && bal) first = atomicAdd(n_live, __popc(bal));
      first = __shfl_sync(FULL_MASK, first, 0);
      if (live) qslot[first + __popc(bal & ((1u << lane) - 1u))] = l;
    }
  }
  __syncthreads();
  const int nq = *n_live;
  if (nq == 0 && !own_row) return;

  // 2. Stage window rows by .. by+4 of columns c-1 .. c+1, then the spill
  //    list, the live entries compacted in order.
  for (int base = 0; base < L.row; base += blockDim.x) {
    const int e = base + threadIdx.x;
    bool live = false;
    if (e < L.cols) {
      const int k = e / W;
      const int col = c - 1 + k;
      if (col >= 0 && col < tx) {
        const long long s = ((long long)col * ty + by) * bucket + (e - k * W);
        live = packed_T[ROW_ID * slots + s] >= 0.f;
      }
    } else if (e < L.row) {
      live = rows[(long long)(e - L.cols) * NUM_F + ROW_ID] >= 0.f;
    }
    const unsigned bal = __ballot_sync(FULL_MASK, live);
    if (lane == 0 && e < L.row) ballots[e >> 5] = bal;
  }
  __syncthreads();
  if (threadIdx.x < 32) scan_ballots(ballots, prefix, L.chunks);
  __syncthreads();
  for (int e = threadIdx.x; e < L.row; e += blockDim.x) {
    if (!((ballots[e >> 5] >> (e & 31)) & 1u)) continue;
    const int dst = live_before(ballots, prefix, e);
    if (e < L.cols) {
      const int k = e / W;
      const long long s =
          ((long long)(c - 1 + k) * ty + by) * bucket + (e - k * W);
      P[dst] = make_float4(packed_T[ROW_PX * slots + s],
                           packed_T[ROW_PY * slots + s],
                           packed_T[ROW_ID * slots + s],
                           packed_T[ROW_PRIO * slots + s]);
      V[dst] = make_float4(packed_T[ROW_VX * slots + s],
                           packed_T[ROW_VY * slots + s],
                           packed_T[ROW_FX * slots + s],
                           packed_T[ROW_FY * slots + s]);
    } else {
      const float* r = rows + (long long)(e - L.cols) * NUM_F;
      P[dst] = make_float4(r[ROW_PX], r[ROW_PY], r[ROW_ID], r[ROW_PRIO]);
      V[dst] = make_float4(r[ROW_VX], r[ROW_VY], r[ROW_FX], r[ROW_FY]);
    }
  }
  __syncthreads();

  // 3. Each thread takes live queries: three column ranges and the live
  //    spills.  Then, in block i = 1, the last warp takes the own row.
  const Params zp = load_params(zp5);
  const int qt = query_threads(bucket);
  unsigned short* list = lists + threadIdx.x;  // entry m: list[m * qt]
  const int sp_lo = live_before(ballots, prefix, L.cols);
  const int sp_hi = prefix[L.chunks];
  const float spx = own[ROW_PX];
  const float spy = own[ROW_PY];

  for (int qi = threadIdx.x; threadIdx.x < qt && qi < nq; qi += qt) {
    const int l = qslot[qi];
    const Query q = load_query(packed_t + (qs0 + l) * NUM_F);
    const int r = qrow - by + l / bucket;  // the query's window tile row
    const int t0 = max(r - 1, 0);
    const int t1 = min(r + 2, 5);
    int lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = live_before(ballots, prefix, k * W + t0 * bucket);
      hi[k] = live_before(ballots, prefix, k * W + t1 * bucket);
    }
    lo[3] = sp_lo;
    hi[3] = sp_hi;
    const float2 o = list_velocity<INT_PRIO>(q, zp, P, V, lo, hi, list,
                                             qt, overflow);
    float* dst = out + 2 * (out0 + i * qb + l);
    dst[0] = o.x;
    dst[1] = o.y;
    const float dx = q.px - spx;
    const float dy = q.py - spy;
    if (dx * dx + dy * dy < q.eye * q.eye) {
      const long long a = (long long)q.id;
      vel[2 * a] = static_cast<VelT>(o.x);
      vel[2 * a + 1] = static_cast<VelT>(o.y);
    }
  }

  if (own_row && threadIdx.x >= blockDim.x - 32) {
    const Query q = load_query(own);
    const int t0 = qrow - by;  // the query block's window tile rows
    int lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = live_before(ballots, prefix, k * W + t0 * bucket);
      hi[k] = live_before(ballots, prefix, k * W + (t0 + 3) * bucket);
    }
    lo[3] = sp_lo;
    hi[3] = sp_hi;
    const float2 o = oracle_velocity(q, zp, P, V, lo, hi);
    if (lane == 0) {
      out[2 * (out0 + 9 * bucket)] = o.x;
      out[2 * (out0 + 9 * bucket) + 1] = o.y;
      const long long a = (long long)q.id;
      vel[2 * a] = static_cast<VelT>(o.x);
      vel[2 * a + 1] = static_cast<VelT>(o.y);
    }
  }
}

template <bool INT_PRIO, class VelT>
cudaError_t launch(const float* zp5, const float* packed_t,
                   const float* packed_T, const float* rows,
                   const int* sp_tcx, const int* sp_tcy,
                   const unsigned char* windows, float* out, void* vel,
                   int* overflow, int n_spill, int tx, int ty, int bucket,
                   cudaStream_t stream) {
  static std::atomic<unsigned> configured{0};
  auto kernel = spill_window_kernel<INT_PRIO, VelT>;
  cudaError_t e = opt_in_shared_memory(
      reinterpret_cast<const void*>(kernel), configured);
  if (e != cudaSuccess) return e;
  const int threads = spill_threads(bucket);
  kernel<<<3 * n_spill, threads, spill_layout(bucket, n_spill).bytes,
           stream>>>(
      zp5, packed_t, packed_T, rows, sp_tcx, sp_tcy, windows, out,
      static_cast<VelT*>(vel), overflow, n_spill, tx, ty, bucket);
  return cudaGetLastError();
}

}  // namespace
}  // namespace crowdsim

extern "C" int crowdsim_spill_window(
    const float* zp5, const float* packed_t, const float* packed_T,
    const float* rows, const int* sp_tcx, const int* sp_tcy,
    const unsigned char* windows, float* out, void* vel, int* overflow,
    int n_spill, int tx, int ty, int bucket, int vel_f64, int int_prio,
    void* stream) {
  using crowdsim::launch;
  const int threads = crowdsim::spill_threads(bucket);
  if (bucket < 1 || threads > crowdsim::MAX_THREADS || tx < 5 || ty < 5 ||
      crowdsim::spill_layout(bucket, n_spill).row > 65536)
    return (int)cudaErrorInvalidValue;
  if (n_spill <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (vel_f64) {
    e = int_prio ? launch<true, double>(zp5, packed_t, packed_T, rows,
                                        sp_tcx, sp_tcy, windows, out, vel,
                                        overflow, n_spill, tx, ty, bucket, s)
                 : launch<false, double>(zp5, packed_t, packed_T, rows,
                                         sp_tcx, sp_tcy, windows, out, vel,
                                         overflow, n_spill, tx, ty, bucket, s);
  } else {
    e = int_prio ? launch<true, float>(zp5, packed_t, packed_T, rows,
                                       sp_tcx, sp_tcy, windows, out, vel,
                                       overflow, n_spill, tx, ty, bucket, s)
                 : launch<false, float>(zp5, packed_t, packed_T, rows,
                                        sp_tcx, sp_tcy, windows, out, vel,
                                        overflow, n_spill, tx, ty, bucket, s);
  }
  return (int)e;
}
