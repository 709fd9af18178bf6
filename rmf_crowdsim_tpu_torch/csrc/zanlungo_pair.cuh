// Zanlungo pair math shared by the force kernel (K1) and the spill-window
// kernel (K2).
//
// The formulation is the TPU kernel's (_pair_ttc / _pair_force,
// rmf_crowdsim_tpu/ops/zanlungo_pallas.py:421-624): half-b time to
// collision, reciprocals hoisted out of the pair loop, and the integer-
// priority specialisation that drops the right-of-way sqrt and the slerp.
// The TPU's asin/sin polynomials become asinf/sinf and its rsqrt becomes
// 1/sqrtf.  The library is built with -fmad=false and these functions
// follow, operation for operation, the plain PyTorch versions in
// ops/zanlungo_bucketed.py (_pair_ttc, _pair_force, pair_mask), so a
// kernel and its plain version take the same discrete decisions (masks,
// TTC branches, flips) and differ only in the order of the force sums.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace crowdsim {

// Feature rows of the packed plane (ops/zanlungo_bucketed.py).
constexpr int ROW_PX = 0, ROW_PY = 1, ROW_VX = 2, ROW_VY = 3;
constexpr int ROW_FX = 4, ROW_FY = 5, ROW_PRIO = 6, ROW_ID = 7;
constexpr int NUM_CAND = 8;
constexpr int ROW_RX = 8, ROW_RY = 9, ROW_EYE = 10;
constexpr int ROW_SPX = 11, ROW_SPY = 12;
constexpr int NUM_F = 16;
constexpr float POS_SENTINEL = 1e30f;
constexpr float HALF_PI = 1.5707963267948966f;

// Sentinel value of candidate feature row f (empty slot).
__device__ __forceinline__ float sentinel_feature(int f) {
  return (f == ROW_PX || f == ROW_PY) ? POS_SENTINEL
                                      : (f == ROW_ID ? -1.f : 0.f);
}

struct Params {
  float agent_scale, force_distance, agent_mass, agent_radius, force_cap;
};

__device__ __forceinline__ Params load_params(const float* zp5) {
  return Params{zp5[0], zp5[1], zp5[2], zp5[3], zp5[4]};
}

struct Query {
  float px, py, vx, vy, spx, spy, prio, id, eye, rx, ry;
};

// Query features from one packed row of 16 floats.
__device__ __forceinline__ Query load_query(const float* row) {
  Query q;
  q.px = row[ROW_PX];
  q.py = row[ROW_PY];
  q.vx = row[ROW_VX];
  q.vy = row[ROW_VY];
  q.spx = row[ROW_SPX];
  q.spy = row[ROW_SPY];
  q.prio = row[ROW_PRIO];
  q.id = row[ROW_ID];
  q.eye = row[ROW_EYE];
  q.rx = row[ROW_RX];
  q.ry = row[ROW_RY];
  return q;
}

// Candidate mask: strict d^2 < eye^2 (location_hash_2d.rs:251), another
// id, a live candidate (the query is live by the caller's check).
__device__ __forceinline__ bool pair_mask(const Query& q, float cpx,
                                          float cpy, float cid) {
  float ddx = cpx - q.px;
  float ddy = cpy - q.py;
  float d2 = ddx * ddx + ddy * ddy;
  return (d2 < q.eye * q.eye) && (cid != q.id) && (cid >= 0.f);
}

// Time to collision (zanlungo.rs:49-74), half-b form.
__device__ __forceinline__ float pair_ttc(const Query& q, float cvx,
                                          float cvy, float cpx, float cpy,
                                          float radius) {
  float rvx = cvx - q.vx;
  float rvy = cvy - q.vy;
  float rpx = cpx - q.px;
  float rpy = cpy - q.py;
  float a = rvx * rvx + rvy * rvy;
  float bh = rvx * rpx + rvy * rpy;
  float c = rpx * rpx + rpy * rpy - radius * radius;
  float disc4 = bh * bh - a * c;
  if (!(a > 0.f) || disc4 < 0.f) return CUDART_INF_F;
  float sq = sqrtf(fmaxf(disc4, 0.f));
  float num0 = -bh - sq;
  float num1 = -bh + sq;
  float res_num = (num0 < 0.f && num1 > 0.f)
                      ? 0.f
                      : (num0 > 0.f ? num0
                                    : (num1 > 0.f ? num1 : CUDART_INF_F));
  return res_num * (1.f / a);
}

// Pair force (zanlungo.rs:93-198) added into (fx, fy), for a pair the
// caller has masked in, with finite t_i and inv_t = 1 / (t_i > 0 ? t_i : 1).
template <bool INT_PRIO>
__device__ __forceinline__ void pair_force(const Params& zp, float t_i,
                                           float inv_t, float neg_inv_fd,
                                           const Query& q, float cpx,
                                           float cpy, float cvx, float cvy,
                                           float cfx, float cfy, float cprio,
                                           float& fx, float& fy) {
  float row = fminf(fmaxf(q.prio - cprio, -1.f), 1.f);
  bool neg_row = row < 0.f;
  float w, mvx, mvy, ovx, ovy;
  if (INT_PRIO) {
    // cv + 1 * (cf - cv), rounded as the general path and the oracle round
    // it: at t_i == 0 one rounding step of speed difference is the
    // difference between no force and force_cap.
    w = row;
    mvx = q.vx;
    mvy = q.vy;
    ovx = neg_row ? cvx + (cfx - cvx) : cvx;
    ovy = neg_row ? cvy + (cfy - cvy) : cvy;
  } else {
    float r2 = sqrtf(fabsf(row));
    float r2n = row < 0.f ? r2 : 0.f;
    float r2p = row > 0.f ? r2 : 0.f;
    float sgn = row > 0.f ? 1.f : (row < 0.f ? -1.f : 0.f);
    w = sgn * r2;
    bool pos_row = row > 0.f;
    mvx = pos_row ? q.vx + r2p * (q.spx - q.vx) : q.vx;
    mvy = pos_row ? q.vy + r2p * (q.spy - q.vy) : q.vy;
    ovx = neg_row ? cvx + r2n * (cfx - cvx) : cvx;
    ovy = neg_row ? cvy + r2n * (cfy - cvy) : cvy;
  }

  float weight = 1.f - w;
  float dx = (q.px + mvx * t_i) - (cpx + ovx * t_i);
  float dy = (q.py + mvy * t_i) - (cpy + ovy * t_i);
  float dist = sqrtf(dx * dx + dy * dy);

  bool stationary = (cfx * cfx + cfy * cfy) < 1e-8f;
  float perp_sx = -(q.py - cpy);
  float perp_sy = q.px - cpx;
  if ((perp_sx * q.vx + perp_sy * q.vy) < 0.f) {
    perp_sx = -perp_sx;
    perp_sy = -perp_sy;
  }
  float perp_mx = -cfy;
  float perp_my = cfx;
  if ((perp_mx * dx + perp_my * dy) < 0.f) {
    perp_mx = -perp_mx;
    perp_my = -perp_my;
  }
  bool interpolate = stationary || ((cfx * dx + cfy * dy) > 0.f);
  float perp_x = stationary ? perp_sx : perp_mx;
  float perp_y = stationary ? perp_sy : perp_my;

  if (INT_PRIO) {
    float cross = perp_x * dy - perp_y * dx;
    if (neg_row && interpolate && fabsf(cross) > 0.f) {
      dx = perp_x;
      dy = perp_y;
    }
  } else {
    float sin_theta = fminf(fabsf(perp_x * dy - perp_y * dx), 1.f);
    float theta = asinf(sin_theta);
    float t_s = weight - 1.f;
    float s0 = sinf(fminf(fmaxf((1.f - t_s) * theta, 0.f), HALF_PI));
    float s1 = sinf(fminf(fmaxf(t_s * theta, 0.f), HALF_PI));
    if (weight > 1.f && interpolate && sin_theta > 0.f) {
      float ndx = dx * s0 + perp_x * s1;
      float ndy = dy * s0 + perp_y * s1;
      dx = ndx;
      dy = ndy;
    }
  }

  float d2n = dx * dx + dy * dy;
  float inv_d = d2n > 0.f ? 1.f / sqrtf(d2n) : 0.f;
  float ux = dx * inv_d;
  float uy = dy * inv_d;

  float surface_dist = dist - 2.f * zp.agent_radius;
  float sdx = mvx - ovx;
  float sdy = mvy - ovy;
  float speed_diff = sqrtf(sdx * sdx + sdy * sdy);
  float magnitude = weight * zp.agent_scale * speed_diff * inv_t;
  if (t_i == 0.f && speed_diff * weight > 0.f) magnitude = CUDART_INF_F;
  magnitude = fminf(magnitude, zp.force_cap);
  float falloff = expf(surface_dist * neg_inv_fd);
  float scale = magnitude * falloff;
  fx += ux * scale;
  fy += uy * scale;
}

}  // namespace crowdsim
