// The dynamic shared-memory opt-in of the port's CUDA kernels, included
// by every csrc/*.cu file that launches with more than the default.
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

// Opt `fn` into `dyn` bytes of dynamic shared memory when that and its
// static shared memory (a CUB scan's temp storage, say) together pass
// the 48 KB a launch gets without opting in. Returns cudaSuccess when no
// opt-in is needed.
template <typename F>
inline cudaError_t opt_in_smem(F* fn, size_t dyn) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess || dyn + fa.sharedSizeBytes <= 48 * 1024) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(dyn));
}
