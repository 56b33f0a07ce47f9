// CPU emulation of the CUDA the kernels in csrc/ use, for checking their
// indexing, staging and fragment layouts on a machine without a card.
//
// Each block of a launch runs as blockDim host threads (std::thread),
// one block after the other; __syncthreads is a barrier over the block,
// and the warp-wide operations (mma.sync, __shfl_xor_sync) are barriers
// over the 32 threads of a warp that exchange their registers through a
// per-warp scratch area. mma.sync multiplies the TF32 operands exactly
// (their low 13 bits cleared, as the tensor cores ignore them) and sums
// in float32. cp.async copies at once. Shared memory starts filled with
// NaN bytes, so a read of a slot the kernel never wrote shows in the
// result. Speed is nothing like the card's; tiny shapes only.
//
// Built by ops/_build.py::load_emulation with a host C++20 compiler and
// -DFNO_EMULATE; launch.cuh includes this file in place of the CUDA
// runtime.
#pragma once

#include <algorithm>
#include <array>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

using cudaError_t = int;
using cudaStream_t = void*;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorInvalidConfiguration = 9;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "error in the CPU emulation"; }
inline int cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
// Few "SMs", so that the persistent head kernel walks several tiles per block.
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return 0;
}
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, K, int, size_t) {
  *v = 1;
  return 0;
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

using std::max;
using std::min;

inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}

namespace emu {

constexpr int kScratch = 8;  // floats per lane: a0-a3, b0-b1, one shuffle value

struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<std::array<float, 32 * kScratch>> scratch;
  std::vector<float4> smem;
};

inline thread_local dim3 thread_idx, block_idx;
inline thread_local Block* block;
inline dim3 grid_dim, block_dim;

inline int lane() { return thread_idx.x % 32; }
inline int warp() { return thread_idx.x / 32; }
inline void warp_sync() { block->warp_bar[warp()]->arrive_and_wait(); }

template <class Kernel>
struct Launch {
  Kernel kernel;
  dim3 grid, threads;
  size_t smem;

  template <class... Args>
  void operator()(Args... args) const {
    grid_dim = grid;
    block_dim = threads;
    const int n = threads.x;  // the kernels here use 1-D blocks of whole warps
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          Block blk;
          blk.bar = std::make_unique<std::barrier<>>(n);
          for (int w = 0; w < n / 32; ++w) {
            blk.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
          }
          blk.scratch.resize(n / 32);
          blk.smem.resize((smem + 15) / 16);
          std::memset(blk.smem.data(), 0xff, blk.smem.size() * sizeof(float4));
          std::vector<std::thread> pool;
          for (int i = 0; i < n; ++i) {
            pool.emplace_back([&, i] {
              block = &blk;
              block_idx = dim3(bx, by, bz);
              thread_idx = dim3(i);
              kernel(args...);
            });
          }
          for (auto& th : pool) th.join();
        }
  }
};

template <class Kernel>
Launch<Kernel> launch(Kernel k, dim3 grid, dim3 threads, size_t smem, cudaStream_t) {
  return {k, grid, threads, smem};
}

}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx
#define gridDim emu::grid_dim
#define blockDim emu::block_dim
#define FNO_LAUNCH(kernel, grid, block, smem, stream) emu::launch(kernel, grid, block, smem, stream)
#define FNO_DYNAMIC_SMEM(type, name) type* name = reinterpret_cast<type*>(emu::block->smem.data())

inline void __syncthreads() { emu::block->bar->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  float* s = emu::block->scratch[emu::warp()].data();
  s[emu::lane() * emu::kScratch + 6] = v;
  emu::warp_sync();
  const float r = s[(emu::lane() ^ mask) * emu::kScratch + 6];
  emu::warp_sync();
  return r;
}

inline void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  float* s = emu::block->scratch[emu::warp()].data();
  const int l = emu::lane();
  for (int i = 0; i < 4; ++i) s[l * emu::kScratch + i] = __uint_as_float(a[i] & 0xffffe000u);
  for (int i = 0; i < 2; ++i) s[l * emu::kScratch + 4 + i] = __uint_as_float(b[i] & 0xffffe000u);
  emu::warp_sync();
  float A[16][8], B[8][8];
  for (int q = 0; q < 32; ++q) {
    const int g = q >> 2, t = q & 3;
    const float* f = s + q * emu::kScratch;
    A[g][t] = f[0];
    A[g + 8][t] = f[1];
    A[g][t + 4] = f[2];
    A[g + 8][t + 4] = f[3];
    B[t][g] = f[4];
    B[t + 4][g] = f[5];
  }
  emu::warp_sync();
  const int g = l >> 2, t = l & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >> 1) * 8, col = 2 * t + (i & 1);
    float sum = 0.f;
    for (int k = 0; k < 8; ++k) sum += A[row][k] * B[k][col];
    d[i] += sum;
  }
}

inline void cp_async16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async4(void* dst, const void* src) { std::memcpy(dst, src, 4); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
