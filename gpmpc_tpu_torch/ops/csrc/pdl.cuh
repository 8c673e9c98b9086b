// Programmatic dependent launch (Hopper): a launch is queued while the
// kernel before it on the stream runs and waits for that kernel's writes
// (griddepcontrol.wait) before it reads anything, so the launch gap between
// the two leaves the device timeline. A launch that sums another's partials
// waits in its first instruction; the forwards of #12, #8 and #2, and #1 and
// #4, follow whatever kernel precedes them the same way (after a plain
// PyTorch kernel too, which ends before the dependent's wait returns), and
// their summing launches release the next launch at once. The order of
// every sum is unchanged.

#pragma once

#include <cuda_runtime.h>

namespace gpmpc_pdl {

// in the launch whose outputs the next one reads: the next may start now
__device__ __forceinline__ void release_dependents() { asm volatile("griddepcontrol.launch_dependents;" ::: "memory"); }

// in the dependent launch, before it reads: wait until the launch before it
// has finished and its writes are visible (a no-op after a plain launch)
__device__ __forceinline__ void wait_for_prerequisite() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// launch kernel as a programmatic dependent of the launch before it on stream
template <typename... KArgs, typename... Args>
int launch_dependent(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                     Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace gpmpc_pdl
