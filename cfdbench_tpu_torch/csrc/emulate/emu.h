// CPU emulation of the CUDA the kernels in csrc/ use, for checking their
// indexing, staging and fragment layouts on a machine without a card.
//
// A launch runs as blockDim host threads (std::thread), which walk its
// blocks one after the other; __syncthreads is a barrier over the block,
// and the warp-wide operations (mma.sync, __shfl_xor_sync) are barriers
// over the 32 threads of a warp that exchange their registers through a
// per-warp scratch area. mma.sync multiplies the TF32 operands exactly
// (their low 13 bits cleared, as the tensor cores ignore them) and sums
// in float32. cp.async copies at once. Shared memory starts filled with
// NaN bytes, so a read of a slot the kernel never wrote shows in the
// result. Speed is nothing like the card's; tiny shapes only.
//
// Hopper's asynchronous machinery (hopper.cuh) has counterparts too:
// wgmma's fence and wait are barriers over the warpgroup (four warps),
// commit is nothing (products run at once), and a product gathers the
// warp's A fragments through its scratch area, reads B from shared
// memory through the descriptor's
// layout (the canonical K-major layout without swizzle; any other layout
// aborts) and takes both operands as the tensor cores take TF32 (the low
// 13 bits cleared). A TMA box is a copy done at once by the issuing
// thread, with the card's 128- or 64-byte swizzle applied to the
// destination's shared-memory offset and zeros outside the tensor; cp.async.bulk a
// memcpy. An mbarrier is a counter of arrivals and bytes with a phase,
// under one lock; a waiter sleeps on the phase until the phase of its
// parity has completed. A named barrier (bar.sync, bar.arrive) is a
// std::barrier per id over the thread count its first user names, made
// anew for each block (an arrival that no waiter matched, as a ping-pong
// leaves at its end, does not carry over); bar.arrive arrives and goes on.
// setmaxnreg does nothing; rcp.approx and ex2.approx are the exact 1 / x
// and 2^x.
//
// Built by ops/_build.py::load_emulation with a host C++20 compiler and
// -DFNO_EMULATE; launch.cuh includes this file in place of the CUDA
// runtime.
#pragma once

#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
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
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
constexpr int cudaSharedmemCarveoutMaxShared = 100;
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
#define __grid_constant__

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
inline float rcp_approx(float x) { return 1.f / x; }
inline float ex2_approx(float x) { return std::exp2(x); }

namespace emu {

constexpr int kScratch = 16;  // floats per lane: a0-a3, b0-b1, one shuffle value; wgmma's A at 8-15

// A warpgroup's barrier.
struct WarpGroup {
  std::unique_ptr<std::barrier<>> bar;
};

struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::mutex named_lock;
  std::unique_ptr<std::barrier<>> named[16];  // named barriers by id, made at first use
  int named_threads[16];
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<std::array<float, 32 * kScratch>> scratch;
  std::vector<WarpGroup> warpgroups;
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
    Block blk;
    blk.bar = std::make_unique<std::barrier<>>(n);
    for (int w = 0; w < n / 32; ++w) {
      blk.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
    }
    blk.scratch.resize(n / 32);
    blk.warpgroups.resize(n / 128);
    for (auto& wg : blk.warpgroups) wg.bar = std::make_unique<std::barrier<>>(128);
    blk.smem.resize((smem + 15) / 16);
    // One host thread per CUDA thread for the whole launch, which walks the
    // blocks in order; shared memory is refilled with NaN bytes between them.
    std::vector<std::thread> pool;
    for (int i = 0; i < n; ++i) {
      pool.emplace_back([&, i] {
        block = &blk;
        thread_idx = dim3(i);
        for (unsigned bz = 0; bz < grid.z; ++bz)
          for (unsigned by = 0; by < grid.y; ++by)
            for (unsigned bx = 0; bx < grid.x; ++bx) {
              if (i == 0) {
                std::memset(blk.smem.data(), 0xff, blk.smem.size() * sizeof(float4));
                for (auto& b : blk.named) b.reset();
              }
              blk.bar->arrive_and_wait();
              block_idx = dim3(bx, by, bz);
              kernel(args...);
              blk.bar->arrive_and_wait();
            }
      });
    }
    for (auto& th : pool) th.join();
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

inline int __shfl_sync(unsigned, int v, int src) {
  float* s = emu::block->scratch[emu::warp()].data();
  std::memcpy(s + emu::lane() * emu::kScratch + 6, &v, 4);
  emu::warp_sync();
  int r;
  std::memcpy(&r, s + src * emu::kScratch + 6, 4);
  emu::warp_sync();
  return r;
}

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

inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp_sync(); }

// ---- hopper.cuh ----

inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<const char*>(p) -
                               reinterpret_cast<const char*>(emu::block->smem.data()));
}

// The phase is an atomic that waiters sleep on (C++20 atomic wait); the
// counts change under one lock.
struct Mbar {
  std::atomic<int> phase;
  int count, pending;
  long long tx;
};

namespace emu {
inline std::mutex mbar_lock;
inline void mbar_settle(Mbar* b) {  // under mbar_lock
  if (b->pending == 0 && b->tx == 0) {
    b->pending = b->count;
    b->phase.fetch_add(1);
    b->phase.notify_all();
  }
}
inline thread_local int wgmma_turn = 0;
inline WarpGroup& warpgroup() { return block->warpgroups[thread_idx.x / 128]; }
inline void wg_sync() { warpgroup().bar->arrive_and_wait(); }
}  // namespace emu

inline void mbar_init(Mbar* b, int count) {
  std::lock_guard<std::mutex> l(emu::mbar_lock);
  new (b) Mbar;
  b->phase.store(0);
  b->count = b->pending = count;
  b->tx = 0;
}
inline void fence_mbar_init() {}
inline void mbar_arrive(Mbar* b) {
  std::lock_guard<std::mutex> l(emu::mbar_lock);
  --b->pending;
  emu::mbar_settle(b);
}
inline void mbar_arrive_expect_tx(Mbar* b, uint32_t bytes) {
  std::lock_guard<std::mutex> l(emu::mbar_lock);
  b->tx += bytes;
  --b->pending;
  emu::mbar_settle(b);
}
inline void mbar_complete_tx(Mbar* b, uint32_t bytes) {
  std::lock_guard<std::mutex> l(emu::mbar_lock);
  b->tx -= bytes;
  emu::mbar_settle(b);
}
inline void mbar_wait(Mbar* b, int parity) {
  for (;;) {
    const int phase = b->phase.load();
    if ((phase & 1) != parity) return;
    b->phase.wait(phase);
  }
}
inline void bulk_load(void* dst, const void* src, uint32_t bytes, Mbar* b) {
  if (bytes % 16 || smem_addr(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16) std::abort();
  std::memcpy(dst, src, bytes);
  mbar_complete_tx(b, bytes);
}

// A tensor map as the kernels use it: float32, 4 dimensions, 128-byte
// swizzle, zeros outside.
struct CUtensorMap {
  const char* base;
  uint64_t dims[4], strides[4];
  uint32_t box[4];
  int swizzle;
};

inline int encode_tensor_map_4d(CUtensorMap* map, const void* base, const uint64_t dims[4],
                                const uint64_t strides[3], const uint32_t box[4], int swizzle) {
  // The card's rules: a 16-byte aligned base and strides, box sides of 1 to
  // 256, and boxes at most as wide as the swizzle's span.
  if (reinterpret_cast<uintptr_t>(base) % 16 || (swizzle != 128 && swizzle != 64) ||
      box[0] * 4 > (uint32_t)swizzle) {
    return cudaErrorInvalidValue;
  }
  map->base = static_cast<const char*>(base);
  map->swizzle = swizzle;
  map->strides[0] = 4;
  for (int i = 0; i < 4; ++i) {
    if (box[i] < 1 || box[i] > 256 || dims[i] < 1) return cudaErrorInvalidValue;
    if (i > 0 && strides[i - 1] % 16) return cudaErrorInvalidValue;
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (i > 0) map->strides[i] = strides[i - 1];
  }
  return cudaSuccess;
}

inline void tma_load_4d(void* dst, const CUtensorMap* map, Mbar* b, int c0, int c1, int c2,
                        int c3) {
  char* smem = reinterpret_cast<char*>(emu::block->smem.data());
  const uint32_t d0 = smem_addr(dst);
  if (d0 % 1024) std::abort();  // the 128-byte swizzle's alignment
  const long long c[4] = {c0, c1, c2, c3};
  uint32_t n = 0;
  for (uint32_t i3 = 0; i3 < map->box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < map->box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < map->box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < map->box[0]; ++i0, ++n) {
          const long long at[4] = {c[0] + i0, c[1] + i1, c[2] + i2, c[3] + i3};
          float v = 0.f;
          bool inside = true;
          long long off = 0;
          for (int i = 0; i < 4; ++i) {
            inside = inside && at[i] >= 0 && at[i] < (long long)map->dims[i];
            off += at[i] * (long long)map->strides[i];
          }
          if (inside) std::memcpy(&v, map->base + off, 4);
          uint32_t o = d0 + 4 * n;
          o ^= ((o >> 7) & (map->swizzle == 128 ? 7 : 3)) << 4;
          std::memcpy(smem + o, &v, 4);
        }
  mbar_complete_tx(b, 4 * n);
}

inline void fence_proxy_async() {}
template <int N>
inline void setmaxnreg_dec() {}  // registers are the host's
template <int N>
inline void setmaxnreg_inc() {}

namespace emu {
inline std::barrier<>& named_barrier(int id, int threads) {
  std::lock_guard<std::mutex> l(block->named_lock);
  if (id < 1 || id > 15 || threads < 32 || threads % 32) std::abort();
  auto& b = block->named[id];
  if (!b) {
    b = std::make_unique<std::barrier<>>(threads);
    block->named_threads[id] = threads;
  } else if (block->named_threads[id] != threads) {
    std::abort();  // one barrier named with two thread counts
  }
  return *b;
}
}  // namespace emu

inline void named_sync(int id, int threads) { emu::named_barrier(id, threads).arrive_and_wait(); }
inline void named_arrive(int id, int threads) { (void)emu::named_barrier(id, threads).arrive(); }

inline void wgmma_fence() { emu::wg_sync(); }
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {
  emu::wg_sync();
}
template <class T>
inline void fence_operand(T&) {}

// d += A . B, one m64nNk8 TF32 product of the calling thread's warpgroup
// (hopper.cuh's layouts). A warp's rows of D need only its own rows of A,
// so the product gathers A over the warp (its scratch area's two halves in
// turns: one barrier a product).
template <int N>
inline void wgmma_tf32(float* d, const uint32_t a[4], uint64_t desc) {
  float* scratch = emu::block->scratch[emu::warp()].data() + 8 + 4 * emu::wgmma_turn;
  emu::wgmma_turn ^= 1;
  const int l = emu::lane();
  for (int i = 0; i < 4; ++i) scratch[l * emu::kScratch + i] = __uint_as_float(a[i] & 0xffffe000u);
  emu::warp_sync();
  if (desc >> 62) std::abort();  // only the layout without swizzle
  const char* smem = reinterpret_cast<const char*>(emu::block->smem.data());
  const uint32_t start = (desc & 0x3FFF) << 4, lbo = ((desc >> 16) & 0x3FFF) << 4,
                 sbo = ((desc >> 32) & 0x3FFF) << 4;
  const int g = l >> 2, t = l & 3;
  float A[2][8];  // this thread's rows g and g + 8 of the warp's 16
  for (int half = 0; half < 2; ++half)
    for (int k = 0; k < 8; ++k)
      A[half][k] = scratch[(4 * g + k % 4) * emu::kScratch + half + 2 * (k / 4)];
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t + e;
      float Bk[8];
      for (int k = 0; k < 8; ++k) {
        uint32_t u;
        std::memcpy(&u, smem + start + (k / 4) * lbo + (n / 8) * sbo + (n % 8) * 16 + (k % 4) * 4,
                    4);
        Bk[k] = __uint_as_float(u & 0xffffe000u);
      }
      for (int half = 0; half < 2; ++half) {
        float sum = 0.f;
        for (int k = 0; k < 8; ++k) sum += A[half][k] * Bk[k];
        d[4 * j + 2 * half + e] += sum;
      }
    }
}
