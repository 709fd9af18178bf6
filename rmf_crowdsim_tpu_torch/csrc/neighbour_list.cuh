// The compacted stage and the per-query neighbour list shared by the
// kernels that stage bucketed candidates in shared memory: K1 and K1b
// (zanlungo_bucketed.cuh) and K2 (spill_window.cu).
//
// A block stages candidate slots with the empty ones (id < 0) removed and
// the order kept: one ballot word per 32 staged slots and an exclusive
// prefix over the words give each live slot its place, so a range of
// slots is a contiguous range of the compacted stage.  A live query then
// walks its ranges once with the mask, appending each hit's staged index
// (uint16) to its LIST_CAP-entry list, and the TTC and force passes walk
// the list.  A query with more hits re-walks its ranges with the mask in
// each pass, in the same order.  Either way every query does the same
// float operations on the same candidates in the same order as a plain
// walk of its ranges, so the result is that walk's, bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "zanlungo_pair.cuh"

namespace crowdsim {

constexpr int LIST_CAP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Live staged slots before flat staged index i (0 <= i <= staged slots).
__device__ __forceinline__ int live_before(const unsigned* ballots,
                                           const int* prefix, int i) {
  const int r = i & 31;
  return prefix[i >> 5] +
         (r ? __popc(ballots[i >> 5] & ((1u << r) - 1u)) : 0);
}

// prefix[c] = live slots of ballot words 0 .. c-1, for c = 0 .. chunks.
// Run by one whole warp.
__device__ __forceinline__ void scan_ballots(const unsigned* ballots,
                                             int* prefix, int chunks) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int base = 0; base < chunks; base += 32) {
    const int c = base + lane;
    const int v = c < chunks ? __popc(ballots[c]) : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += t;
    }
    if (c < chunks) prefix[c] = carry + incl - v;
    carry += __shfl_sync(FULL_MASK, incl, 31);
  }
  if (lane == 0) prefix[chunks] = carry;
}

// Calls f(j) for every staged candidate j of the NR ranges [lo[k], hi[k])
// that the query's mask takes, in order.  P[j] = (px, py, id, prio).
template <int NR, class F>
__device__ __forceinline__ void walk(const Query& q, const float4* P,
                                     const int (&lo)[NR], const int (&hi)[NR],
                                     F&& f) {
#pragma unroll
  for (int k = 0; k < NR; ++k) {
#pragma unroll 4
    for (int j = lo[k]; j < hi[k]; ++j) {
      const float4 p = P[j];
      if (pair_mask(q, p.x, p.y, p.z)) f(j);
    }
  }
}

// Where list_velocity stops: after the mask pass, after the TTC pass, or
// at the velocity.  The cuts serve the K1 stage probe (k1_stages.cu); a
// cut returns what it computed, so that no pass it runs is dead.
constexpr int LIST_MASK = 3, LIST_TTC = 4, LIST_FULL = 5;

// rec + F / m of the live query q over the candidates of its ranges that
// its mask takes: one mask pass into the list (entry m at list[m *
// stride]), then the TTC and force passes over the list, or over the
// ranges again where the hits overflow it (counted in *overflow where
// that is given).  V[j] = (vx, vy, fx, fy).  STAGE LIST_MASK returns
// (hits, 1 if they overflow the list else 0), LIST_TTC (t_i, hits).
template <bool INT_PRIO, int STAGE = LIST_FULL, int NR>
__device__ __forceinline__ float2 list_velocity(
    const Query& q, const Params& zp, const float4* P, const float4* V,
    const int (&lo)[NR], const int (&hi)[NR], unsigned short* list,
    int stride, int* overflow) {
  int n = 0;
  walk(q, P, lo, hi, [&](int j) {
    if (n < LIST_CAP) list[n * stride] = (unsigned short)j;
    ++n;
  });
  const bool over = n > LIST_CAP;
  if (over && overflow != nullptr) atomicAdd(overflow, 1);
  if constexpr (STAGE == LIST_MASK) {
    return make_float2((float)n, over ? 1.f : 0.f);
  }

  float t_i = CUDART_INF_F;
  auto ttc = [&](int j) {
    const float4 p = P[j];
    const float4 v = V[j];
    t_i = fminf(t_i, pair_ttc(q, v.x, v.y, p.x, p.y, zp.agent_radius));
  };
  if (over) {
    walk(q, P, lo, hi, ttc);
  } else {
    for (int m = 0; m < n; ++m) ttc(list[m * stride]);
  }
  if constexpr (STAGE == LIST_TTC) {
    return make_float2(t_i, (float)n);
  }

  float2 o = make_float2(q.rx, q.ry);
  if (isfinite(t_i)) {
    const float inv_t = 1.f / (t_i > 0.f ? t_i : 1.f);
    const float neg_inv_fd = -1.f / zp.force_distance;
    float fx = 0.f;
    float fy = 0.f;
    auto force = [&](int j) {
      const float4 p = P[j];
      const float4 v = V[j];
      pair_force<INT_PRIO>(zp, t_i, inv_t, neg_inv_fd, q, p.x, p.y, v.x, v.y,
                           v.z, v.w, p.w, fx, fy);
    };
    if (over) {
      walk(q, P, lo, hi, force);
    } else {
      for (int m = 0; m < n; ++m) force(list[m * stride]);
    }
    const float inv_mass = 1.f / zp.agent_mass;
    o.x = q.rx + fx * inv_mass;
    o.y = q.ry + fy * inv_mass;
  }
  return o;
}

}  // namespace crowdsim
