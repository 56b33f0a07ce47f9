// Launch helpers shared by the FNO kernels.
//
// Built with -DFNO_EMULATE (see emulate/emu.h) the same sources compile
// with a host C++ compiler into a CPU emulation of the launches, so the
// kernels' indexing can be checked on a machine without a card.
#pragma once

#ifdef FNO_EMULATE
#include "emulate/emu.h"
#else
#include <cuda_runtime.h>
// kernel<<<grid, block, smem, stream>>>(args), spelled so that the
// emulation can take the launch over.
#define FNO_LAUNCH(kernel, grid, block, smem, stream) kernel<<<grid, block, smem, stream>>>
#define FNO_DYNAMIC_SMEM(type, name) extern __shared__ type name[]
#endif

#include <cstddef>
#include <cstdint>
#include <cstdio>

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

// Blocks of a persistent kernel: as many as fit on the current device at
// once, at most `items`. The answer is kept per (device, kernel, shared
// memory), since the runtime queries cost host time on every launch.
template <class Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem, long long items,
                              int* blocks) {
  struct Entry {
    int dev;
    const void* kernel;
    size_t smem;
    int fit;
  };
  static Entry cache[16];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  int fit = 0;
  for (int i = 0; i < used; ++i) {
    if (cache[i].dev == dev && cache[i].kernel == (const void*)kernel && cache[i].smem == smem) {
      fit = cache[i].fit;
    }
  }
  if (!fit) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)))
      return err;
    fit = sms * (per_sm > 0 ? per_sm : 1);
    if (used < 16) cache[used++] = Entry{dev, (const void*)kernel, smem, fit};
  }
  *blocks = static_cast<int>(items < fit ? items : fit);
  return cudaSuccess;
}

__device__ __forceinline__ float gelu_erf(float y) {
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr int ceil_div(int n, int m) { return (n + m - 1) / m; }

// The coordinates (i0 fastest, then i1, then i2) of a flat index that
// starts at `start` and advances by `step`, over a row-major space whose
// two fast extents are n0 and n1: a staging loop's per-element divisions
// become a few adds and compares (division by a run-time value costs
// about 20 instructions).
struct Walk3 {
  int i0, i1, i2, d0, d1, d2, n0, n1;
  __device__ __forceinline__ Walk3(int start, int step, int n0_, int n1_) : n0(n0_), n1(n1_) {
    i0 = start % n0;
    i1 = (start / n0) % n1;
    i2 = start / n0 / n1;
    d0 = step % n0;
    d1 = (step / n0) % n1;
    d2 = step / n0 / n1;
  }
  __device__ __forceinline__ void next() {
    i0 += d0;
    int carry = i0 >= n0;
    i0 -= carry ? n0 : 0;
    i1 += d1 + carry;
    carry = i1 >= n1;
    i1 -= carry ? n1 : 0;
    i2 += d2 + carry;
  }
};
