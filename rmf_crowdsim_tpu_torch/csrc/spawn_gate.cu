// G1: the spawn clearance gate, in one launch: for each source, whether an
// alive agent lies strictly within the clearance of it.
//
// Replaces no Pallas kernel: the JAX package's gate is plain jnp over
// [64, N] planes (rmf_crowdsim_tpu/core/step.py:100-125), and so was the
// port's (ops/spawn_gate.py spawn_blocked_plain).  On the H100 those
// planes made the gate the largest cost of a streaming step: 131 launches
// and ~21 ms of device time a step at 1M slots and 1,024 sources, ~50 GB
// of memory traffic for work whose inputs are 9.4 MB.
//
// Contract (ops/spawn_gate.py spawn_blocked): blocked[s] is set to 1 for
// every source s with an alive slot i whose
//   d2 = (x_i - sx)*(x_i - sx) + (y_i - sy)*(y_i - sy)
// (each operation rounded in T, -fmad=false) is below `threshold`, the
// least T whose correctly rounded square root is not below the clearance
// rounded to T (spawn_gate.clearance_threshold).  sqrt_rn is monotone, so
// d2 < threshold exactly when sqrt(d2) < clearance: the decisions equal
// the plain version's sqrt-and-compare bit for bit, ties at the edge and
// NaN or infinite positions included.  blocked is zeroed by the caller;
// entries of sources no alive agent blocks are not written.
//
// Bound on the H100: f32 operations.  At 1M live agents and 1,024 sources
// the 6 operations a pair (two subtractions, two products, a sum, a
// compare) are 6.1 G, ~0.092 ms at 67 TFLOP/s; the inputs are read once
// (9 bytes a slot and a source, ~3 us at 3.35 TB/s).  Separate rounding
// forbids the FFMA, so an instruction is one operation and the kernel can
// reach about half the FLOP/s figure.  The design keeps every
// intermediate in registers:
//   1. A thread holds GATE_SLOTS slots' (x, y) in registers, loaded once
//      (coalesced; neighbouring threads on neighbouring slots).  A dead
//      slot, or one past n, holds NaN, which no comparison passes.  A
//      block whose slots are all dead exits before staging.
//   2. The block stages the source table into shared memory, GATE_STAGE
//      sources at a time; every thread walks it with broadcast reads.
//   3. Each source costs a thread GATE_SLOTS pair tests and a predicated
//      byte store on a hit (hits are rare: an idempotent store of 1).
#include <cuda_runtime.h>

namespace crowdsim {
namespace {

constexpr int GATE_THREADS = 256;
constexpr int GATE_SLOTS = 8;       // agent slots a thread
constexpr int GATE_STAGE = 2048;    // sources staged at a time

template <typename T>
struct alignas(2 * sizeof(T)) Point {
  T x, y;
};

__device__ __forceinline__ float quiet_nan(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
__global__ void __launch_bounds__(GATE_THREADS)
spawn_gate_kernel(const Point<T>* __restrict__ position,
                  const unsigned char* __restrict__ alive,
                  const Point<T>* __restrict__ sources,
                  unsigned char* __restrict__ blocked, int n, int s,
                  T threshold) {
  __shared__ Point<T> stage[GATE_STAGE];
  const T nan = quiet_nan(T(0));
  const int first = blockIdx.x * (GATE_THREADS * GATE_SLOTS) + threadIdx.x;
  T px[GATE_SLOTS], py[GATE_SLOTS];
  bool any = false;
#pragma unroll
  for (int j = 0; j < GATE_SLOTS; ++j) {
    const int i = first + j * GATE_THREADS;
    const bool live = i < n && alive[i];
    Point<T> p = {nan, nan};
    if (live) p = position[i];
    px[j] = p.x;
    py[j] = p.y;
    any |= live;
  }
  if (!__syncthreads_or(any)) return;
  for (int s0 = 0; s0 < s; s0 += GATE_STAGE) {
    const int count = min(GATE_STAGE, s - s0);
    __syncthreads();
    for (int k = threadIdx.x; k < count; k += GATE_THREADS)
      stage[k] = sources[s0 + k];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < count; ++k) {
      const Point<T> q = stage[k];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < GATE_SLOTS; ++j) {
        const T dx = px[j] - q.x;
        const T dy = py[j] - q.y;
        hit |= dx * dx + dy * dy < threshold;
      }
      if (hit) blocked[s0 + k] = 1;
    }
  }
}

template <typename T>
cudaError_t launch_gate(const void* position, const unsigned char* alive,
                        const void* sources, unsigned char* blocked, int n,
                        int s, double threshold, cudaStream_t stream) {
  const int per_block = GATE_THREADS * GATE_SLOTS;
  spawn_gate_kernel<T><<<(n + per_block - 1) / per_block, GATE_THREADS, 0,
                         stream>>>(
      static_cast<const Point<T>*>(position), alive,
      static_cast<const Point<T>*>(sources), blocked, n, s,
      static_cast<T>(threshold));
  return cudaGetLastError();
}

}  // namespace
}  // namespace crowdsim

// position [n, 2] and sources [s, 2] of float (f64 = 0) or double
// (f64 = 1), each row aligned to its size; alive [n] bool; blocked [s]
// uint8, zeroed; threshold a value of that type.
extern "C" int crowdsim_spawn_gate(const void* position,
                                   const unsigned char* alive,
                                   const void* sources,
                                   unsigned char* blocked, int n, int s,
                                   int f64, double threshold, void* stream) {
  if (n < 0 || s < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || s == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      f64 ? crowdsim::launch_gate<double>(position, alive, sources, blocked,
                                          n, s, threshold, st)
          : crowdsim::launch_gate<float>(position, alive, sources, blocked,
                                         n, s, threshold, st);
  return (int)e;
}
