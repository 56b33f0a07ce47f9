// Launch helpers shared by the FNO kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

// Dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kMaxDynamicSmem = 232448;

// Above 48 KB a kernel only gets dynamic shared memory after it opts in.
// Returns an error instead of launching a kernel the card would refuse.
inline cudaError_t allow_dynamic_smem(const void* kernel, size_t bytes) {
  if (bytes > kMaxDynamicSmem) return cudaErrorInvalidConfiguration;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

__device__ __forceinline__ float gelu_erf(float y) {
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}
