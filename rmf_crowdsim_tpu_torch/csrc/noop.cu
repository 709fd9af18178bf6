// The launch floor: an empty kernel, <<<1, 32>>>, behind the same plain C
// interface as every kernel of this directory.  It replaces no TPU
// kernel.  Its device time is the least any launch takes on the card, and
// its host time a call through utils/cuda_build.launch is what the binding
// adds to every kernel's call (probes/launch.py measures both).
#include <cuda_runtime.h>

namespace crowdsim {
namespace {

__global__ void noop_kernel() {}

}  // namespace
}  // namespace crowdsim

extern "C" int crowdsim_noop(void* stream) {
  crowdsim::noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
