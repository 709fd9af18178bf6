// P1/P2: K1 cut after each of its own stages, to time the stages.
//
// Replaces the TPU probes perf/kvar.py (make_stage_kernel :45,
// pallas_call :270) and perf/kvar2.py (make_stage_kernel :47, pallas_call
// :311 and :315), which build the TPU kernel cumulatively, stage by stage
// (window reads, rolls, query reads, the mask pass, union and rank, the
// one-hot compaction, TTC, force), so that consecutive deltas give each
// stage's cost.  The GPU kernel has other stages, so this probe cuts the
// port's own K1 (zanlungo_bucketed.cuh, its STAGE parameter) after each of
// them: the grid alone, the query listing, the compacted stage, the mask
// pass into the lists, the TTC pass, and the whole kernel.  Each cut
// writes what it computed into `out` (the header lists what), so no pass
// it runs is dead, and each has a plain version (probes/k1_stages.py).
//
// Every cut launches K1's grid with K1's shared memory, so its occupancy
// is the whole kernel's, and its bound (utils/roofline.py k1_stage_bytes
// and k1_stage_ops) counts the bytes that the cut reads and writes and,
// from the mask pass on, the operations of the passes it runs.  The
// threads a block are the caller's: the main path's rule
// (ops/zanlungo_bucketed.py k1_geometry) or another, to time K1 at K4's.
#include <cuda_runtime.h>

#include "zanlungo_bucketed.cuh"

namespace crowdsim {
namespace {

template <int STAGE>
cudaError_t launch_stage(int int_prio, const float* zp5,
                         const float* packed_t, const float* packed_T,
                         float* out, int* overflow, int tx, int ty,
                         int bucket, int T, int threads,
                         cudaStream_t stream) {
  return int_prio ? launch<true, false, STAGE>(
                        zp5, packed_t, packed_T, nullptr, nullptr, out,
                        overflow, tx, ty, bucket, T, threads, 1, 0, stream)
                  : launch<false, false, STAGE>(
                        zp5, packed_t, packed_T, nullptr, nullptr, out,
                        overflow, tx, ty, bucket, T, threads, 1, 0, stream);
}

}  // namespace
}  // namespace crowdsim

// stage: 0 floor, 1 queries, 2 staged, 3 mask, 4 ttc, 5 full.
extern "C" int crowdsim_k1_stage(const float* zp5, const float* packed_t,
                                 const float* packed_T, float* out,
                                 int* overflow, int tx, int ty, int bucket,
                                 int T, int threads, int int_prio, int stage,
                                 void* stream) {
  using namespace crowdsim;
  cudaError_t e = check_geometry(bucket, T, threads, 0);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case K1_FLOOR:
      return (int)launch_stage<K1_FLOOR>(int_prio, zp5, packed_t, packed_T,
                                         out, overflow, tx, ty, bucket, T,
                                         threads, s);
    case K1_QUERIES:
      return (int)launch_stage<K1_QUERIES>(int_prio, zp5, packed_t,
                                           packed_T, out, overflow, tx, ty,
                                           bucket, T, threads, s);
    case K1_STAGED:
      return (int)launch_stage<K1_STAGED>(int_prio, zp5, packed_t, packed_T,
                                          out, overflow, tx, ty, bucket, T,
                                          threads, s);
    case LIST_MASK:
      return (int)launch_stage<LIST_MASK>(int_prio, zp5, packed_t, packed_T,
                                          out, overflow, tx, ty, bucket, T,
                                          threads, s);
    case LIST_TTC:
      return (int)launch_stage<LIST_TTC>(int_prio, zp5, packed_t, packed_T,
                                         out, overflow, tx, ty, bucket, T,
                                         threads, s);
    case K1_FULL:
      return (int)launch_stage<K1_FULL>(int_prio, zp5, packed_t, packed_T,
                                        out, overflow, tx, ty, bucket, T,
                                        threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
