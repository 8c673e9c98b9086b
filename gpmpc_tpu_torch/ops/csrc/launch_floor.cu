// A launch that does nothing, for measuring the launch floor: the device
// time per call of a kernel with no work, which no design of a kernel can
// go below. Launched plainly, or as a programmatic dependent of the launch
// before it (then it releases its own dependents and waits, as the port's
// dependent kernels do before their first read).

#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

__global__ void empty_kernel(int dependent) {
  if (dependent) {
    gpmpc_pdl::release_dependents();
    gpmpc_pdl::wait_for_prerequisite();
  }
}

}  // namespace

extern "C" int gpmpc_empty_launch(int blocks, int threads, int dependent, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dependent) return gpmpc_pdl::launch_dependent(empty_kernel, blocks, threads, 0, s, 1);
  empty_kernel<<<blocks, threads, 0, s>>>(0);
  return (int)cudaGetLastError();
}
