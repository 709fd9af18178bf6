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
// Bound on the H100: operations, barely.  At the 1M bench scene (bucket
// 32, 239 x 240 tiles, 999,938 of 1,835,520 slots live) the kernel's
// f32 operations (a mask test per live pair of a 3x3 window, the pair
// math on the hits) take 0.033 ms at 67 TFLOP/s; the bytes its inputs
// need (each live slot's 11 query and 8 candidate features and its
// output, each empty slot's id, rec and output) take 0.030 ms at
// 3.35 TB/s.  utils/roofline.py computes both from the run's inputs.
//
// The first design (one thread per slot, two full passes over the 288
// staged slots of the 3x3 window) ran at ~3% of that bound, held back by
// instruction issue:
//   1. 46% of the slots are empty, and their lanes rode along in every
//      warp; each query tested all 288 staged slots, ~131 of them empty;
//   2. each pass re-ran the mask over all 288 slots (576 tests a query);
//   3. a warp ran the pair math for slot j whenever any lane masked j in,
//      so ~70-90 pair bodies per pass for ~8 true neighbours a lane.
// This design answers each point:
//   1. Compact at staging.  The block stages the candidates of the
//      3 x (T+2) tiles around its run with the empty slots (id < 0)
//      removed and the order kept: one ballot word per 32 staged slots
//      and an exclusive prefix over the words give each live slot its
//      place, so a query's three column ranges are contiguous and every
//      query walks the first design's candidate sequence minus slots
//      that its mask rejects anyway.  A carried binning packs fresh-dead
//      agents inert inside a bucket, so no prefix-of-bucket shortcut is
//      assumed.  Threads take the block's live queries (warp-aggregated,
//      slot order within a warp); empty slots get their rec row first,
//      and a block with no live query exits before staging.
//   2. One mask pass.  It tests each compacted candidate once and appends
//      the staged index of every hit, in walk order, to the query's list
//      in shared memory (uint16, LIST_CAP entries).  The TTC pass and the
//      force pass then walk the list, in the same order, so each query's
//      float operations are the first design's and so is its result, bit
//      for bit.  A query with more than LIST_CAP hits re-walks the
//      compacted window (and segment) with the mask for each pass, in the
//      same order, so the result stays exact; the optional counter
//      `overflow` counts such queries.
//   3. Divergence follows the longest list in a warp (~10-15 at the bench
//      density), not the union of the lanes' windows.
// The compaction helpers and the list passes are in neighbour_list.cuh,
// which K2 (spill_window.cu) shares.
// K1b stages the spill plane (4 KB at n_sp = 128) behind the window, only
// in blocks that hold a flagged live query, and walks it as a fourth
// segment after the window for flagged queries, in the list and the
// re-walk alike.
//
// Shared memory (make_layout; k1_geometry in ops/zanlungo_bucketed.py
// mirrors it to refuse, before the launch, a block the H100 cannot hold):
// the staged candidates as two float4 arrays [cols + n_sp],
// (px, py, id, prio) for the mask walk's one 16-byte load a candidate and
// (vx, vy, fx, fy) for the pair math; the ballot words and their prefix;
// the lists [LIST_CAP][threads] uint16; the live-query slots
// [T * bucket] uint16; one counter.
//
// Stage cuts.  The template's STAGE says where the kernel stops; the
// main path (zanlungo_bucketed.cu) runs K1_FULL.  The stage probe
// (k1_stages.cu, probes/k1_stages.py) runs each cut to time the stages:
// each one writes what it computed into `out`, so that no pass it runs is
// dead, and empty slots get their rec row at every stage:
//   K1_FLOOR    the grid only: every slot of the block gets its rec row;
//   K1_QUERIES  + step 1, the live queries listed; each writes its rec;
//   K1_STAGED   + step 2, the compacted stage; a live query writes (the
//               live candidates of its three ranges, 0);
//   LIST_MASK   + the mask pass into the list: (hits, hits > LIST_CAP);
//   LIST_TTC    + the TTC pass: (t_i, hits);
//   K1_FULL     the kernel.
// The kernel and its launch sit in an unnamed namespace, so that every
// source that includes this header compiles its own instantiations.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

#include "neighbour_list.cuh"
#include "smem.cuh"
#include "zanlungo_pair.cuh"

namespace crowdsim {

constexpr int MAX_THREADS = 512;

constexpr int K1_FLOOR = 0, K1_QUERIES = 1, K1_STAGED = 2;
constexpr int K1_FULL = LIST_FULL;

struct Layout {
  int cols;    // staged window slots, 3 * (T + 2) * bucket
  int row;     // staged candidates: cols + n_sp
  int chunks;  // ballot words, ceil(cols / 32)
  size_t stage_off, ballot_off, prefix_off, list_off, qslot_off, count_off;
  size_t bytes;
};

__host__ __device__ __forceinline__ Layout make_layout(int T, int bucket,
                                                       int threads,
                                                       int n_sp) {
  Layout L;
  L.cols = 3 * (T + 2) * bucket;
  L.row = L.cols + n_sp;
  L.chunks = (L.cols + 31) / 32;
  size_t o = 0;
  L.stage_off = o;
  o = align16(o + sizeof(float) * NUM_CAND * L.row);
  L.ballot_off = o;
  o = align16(o + sizeof(unsigned) * L.chunks);
  L.prefix_off = o;
  o = align16(o + sizeof(int) * (L.chunks + 1));
  L.list_off = o;
  o = align16(o + sizeof(unsigned short) * LIST_CAP * threads);
  L.qslot_off = o;
  o = align16(o + sizeof(unsigned short) * T * bucket);
  L.count_off = o;
  L.bytes = align16(o + sizeof(int));
  return L;
}

// The launch geometry the caller chose (ops/zanlungo_bucketed.py
// k1_geometry): T tiles of one column a block, `threads` a block.
inline cudaError_t check_geometry(int bucket, int T, int threads, int n_sp) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32 || T < 1 ||
      bucket < 1 || T * bucket > 65535 ||
      make_layout(T, bucket, threads, n_sp).row > 65536)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

namespace {

template <bool INT_PRIO, bool SPILL, int STAGE = K1_FULL>
__global__ void __launch_bounds__(MAX_THREADS)
    zanlungo_bucketed_kernel(const float* __restrict__ zp5,
                             const float* __restrict__ packed_t,
                             const float* __restrict__ packed_T,
                             const int* __restrict__ sflag,
                             const float* __restrict__ sp_T,
                             float* __restrict__ out,
                             int* __restrict__ overflow, int tx, int ty,
                             int bucket, int T, int sub_tiles, int n_sp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(T, bucket, blockDim.x, SPILL ? n_sp : 0);
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
  const int runs = (ty + T - 1) / T;
  const int tcx = blockIdx.x / runs;
  const int tcy0 = (blockIdx.x % runs) * T;
  const int nslots = min(T, ty - tcy0) * bucket;  // in-world query slots
  const long long qs0 = ((long long)tcx * ty + tcy0) * bucket;
  const int lane = threadIdx.x & 31;
  const int n_sub = ty / sub_tiles;

  if constexpr (STAGE == K1_FLOOR) {
    for (int i = threadIdx.x; i < nslots; i += blockDim.x) {
      const long long s = qs0 + i;
      out[2 * s] = packed_t[s * NUM_F + ROW_RX];
      out[2 * s + 1] = packed_t[s * NUM_F + ROW_RY];
    }
    return;
  }

  if (threadIdx.x == 0) *n_live = 0;
  __syncthreads();

  // 1. Queries: empty slots get their rec row; live slots are listed.
  bool any_flagged = false;
  for (int base = 0; base < nslots; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool in = i < nslots;
    const long long s = qs0 + i;
    const bool live = in && packed_T[ROW_ID * slots + s] >= 0.f;
    if (in && !live) {
      out[2 * s] = packed_t[s * NUM_F + ROW_RX];
      out[2 * s + 1] = packed_t[s * NUM_F + ROW_RY];
    }
    const unsigned bal = __ballot_sync(FULL_MASK, live);
    int first = 0;
    if (lane == 0 && bal) first = atomicAdd(n_live, __popc(bal));
    first = __shfl_sync(FULL_MASK, first, 0);
    if (live) qslot[first + __popc(bal & ((1u << lane) - 1u))] = i;
    if (SPILL) {
      const bool flagged =
          live && sflag[tcx * n_sub + (tcy0 + i / bucket) / sub_tiles] > 0;
      any_flagged |= __syncthreads_or(flagged) != 0;
    }
  }
  __syncthreads();
  const int nq = *n_live;
  if (nq == 0) return;

  if constexpr (STAGE == K1_QUERIES) {
    for (int qi = threadIdx.x; qi < nq; qi += blockDim.x) {
      const long long qs = qs0 + qslot[qi];
      out[2 * qs] = packed_t[qs * NUM_F + ROW_RX];
      out[2 * qs + 1] = packed_t[qs * NUM_F + ROW_RY];
    }
    return;
  }

  // 2. Stage the window's live candidates, compacted in order.
  const int W = (T + 2) * bucket;  // staged slots of one column
  for (int base = 0; base < L.cols; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool live = false;
    if (i < L.cols) {
      const int k = i / W;
      const int j = i - k * W;
      const int c = tcx + k - 1;
      const int tile = tcy0 - 1 + j / bucket;
      if (c >= 0 && c < tx && tile >= 0 && tile < ty) {
        const long long s = ((long long)c * ty + tile) * bucket + j % bucket;
        live = packed_T[ROW_ID * slots + s] >= 0.f;
      }
    }
    const unsigned bal = __ballot_sync(FULL_MASK, live);
    if (lane == 0 && i < L.cols) ballots[i >> 5] = bal;
  }
  __syncthreads();
  if (threadIdx.x < 32) scan_ballots(ballots, prefix, L.chunks);
  __syncthreads();
  for (int i = threadIdx.x; i < L.cols; i += blockDim.x) {
    const unsigned bal = ballots[i >> 5];
    if (!((bal >> (i & 31)) & 1u)) continue;
    const int dst = live_before(ballots, prefix, i);
    const int k = i / W;
    const int j = i - k * W;
    const long long s =
        ((long long)(tcx + k - 1) * ty + tcy0 - 1 + j / bucket) * bucket +
        j % bucket;
    P[dst] = make_float4(packed_T[ROW_PX * slots + s],
                         packed_T[ROW_PY * slots + s],
                         packed_T[ROW_ID * slots + s],
                         packed_T[ROW_PRIO * slots + s]);
    V[dst] = make_float4(packed_T[ROW_VX * slots + s],
                         packed_T[ROW_VY * slots + s],
                         packed_T[ROW_FX * slots + s],
                         packed_T[ROW_FY * slots + s]);
  }
  if (SPILL && any_flagged) {
    for (int i = threadIdx.x; i < n_sp; i += blockDim.x) {
      P[L.cols + i] = make_float4(sp_T[ROW_PX * n_sp + i],
                                  sp_T[ROW_PY * n_sp + i],
                                  sp_T[ROW_ID * n_sp + i],
                                  sp_T[ROW_PRIO * n_sp + i]);
      V[L.cols + i] = make_float4(sp_T[ROW_VX * n_sp + i],
                                  sp_T[ROW_VY * n_sp + i],
                                  sp_T[ROW_FX * n_sp + i],
                                  sp_T[ROW_FY * n_sp + i]);
    }
  }
  __syncthreads();

  // 3. Each thread takes live queries: one mask pass that records the
  //    hits, then the TTC and force passes over the list.
  const Params zp = load_params(zp5);
  unsigned short* list = lists + threadIdx.x;  // entry m: list[m * threads]

  for (int qi = threadIdx.x; qi < nq; qi += blockDim.x) {
    const int i = qslot[qi];
    const int lt = i / bucket;
    const long long qs = qs0 + i;
    const Query q = load_query(packed_t + qs * NUM_F);
    const bool flagged =
        SPILL && sflag[tcx * n_sub + (tcy0 + lt) / sub_tiles] > 0;
    // Staged tiles tcy - 1 .. tcy + 1 of column k; tiles outside the world
    // hold no live slot, so their ranges are empty.  Flagged queries (K1b)
    // walk the spill segment [cols, cols + n_sp) last.
    int lo[SPILL ? 4 : 3], hi[SPILL ? 4 : 3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = live_before(ballots, prefix, k * W + lt * bucket);
      hi[k] = live_before(ballots, prefix, k * W + (lt + 3) * bucket);
    }
    if constexpr (SPILL) {
      lo[3] = L.cols;
      hi[3] = flagged ? L.cols + n_sp : L.cols;
    }
    float2 o;
    if constexpr (STAGE == K1_STAGED) {
      int n = 0;
#pragma unroll
      for (int k = 0; k < (SPILL ? 4 : 3); ++k) n += hi[k] - lo[k];
      o = make_float2((float)n, 0.f);
    } else {
      o = list_velocity<INT_PRIO, STAGE>(q, zp, P, V, lo, hi, list,
                                         blockDim.x, overflow);
    }
    out[2 * qs] = o.x;
    out[2 * qs + 1] = o.y;
  }
}

// The kernel opts into the SM's whole shared memory once per device
// (three blocks of the bench geometry, ~70 KB each, share an SM).
template <bool INT_PRIO, bool SPILL, int STAGE = K1_FULL>
cudaError_t launch(const float* zp5, const float* packed_t,
                   const float* packed_T, const int* sflag, const float* sp_T,
                   float* out, int* overflow, int tx, int ty, int bucket,
                   int T, int threads, int sub_tiles, int n_sp,
                   cudaStream_t stream) {
  static std::atomic<unsigned> configured{0};
  cudaError_t e = opt_in_shared_memory(
      reinterpret_cast<const void*>(
          zanlungo_bucketed_kernel<INT_PRIO, SPILL, STAGE>),
      configured);
  if (e != cudaSuccess) return e;
  const int runs = (ty + T - 1) / T;
  const size_t smem = make_layout(T, bucket, threads, SPILL ? n_sp : 0).bytes;
  zanlungo_bucketed_kernel<INT_PRIO, SPILL, STAGE>
      <<<tx * runs, threads, smem, stream>>>(zp5, packed_t, packed_T, sflag,
                                             sp_T, out, overflow, tx, ty,
                                             bucket, T, sub_tiles, n_sp);
  return cudaGetLastError();
}

}  // namespace

}  // namespace crowdsim
