// Hopper's asynchronous machinery for the FNO kernels' Hopper routes
// (sm_90a): wgmma, TMA, mbarrier, named barriers, and the host's tensor
// maps.
//
// wgmma.mma_async (warpgroup matrix multiply) is the only instruction that
// reaches the tensor cores' full rate on this card; mma.sync (tf32.cuh)
// measured about 320 TFLOP/s of TF32 against the data sheet's 495. Four
// warps (a warpgroup) issue one m64nNk8 TF32 product together: D (64 x N,
// float32, in registers) += A (64 x 8) . B (8 x N).
//   A comes from registers (the "RS" form), split as tf32.cuh splits
//   operands: warp w of the warpgroup holds rows 16w .. 16w + 15 in
//   mma.sync's m16n8k8 A layout, a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//   a3 (g + 8, t + 4), lane = 4 g + t.
//   B comes from shared memory through a 64-bit descriptor, K-major (TF32
//   takes no other: CUTLASS's SM90 TF32 atoms are all "TN"): its rows are
//   the N index, K contiguous, in the canonical layout without swizzle.
//   Core matrices of 8 rows x 4 floats (128 contiguous bytes) hold element
//   (n, k) at byte (k / 4) LBO + (n / 8) SBO + (n % 8) 16 + (k % 4) 4
//   from the descriptor's start; a k-step of 8 moves the start by 2 LBO.
//   The host and the kernel write every B operand in this layout, its high
//   and low halves in two planes.
//   D: row 16w + g (+ 8), column 8j + 2t (+ 1) in d[4j + 0..3] (d[4j] (g,
//   2t), d[4j + 1] (g, 2t + 1), d[4j + 2] (g + 8, 2t), d[4j + 3] (g + 8,
//   2t + 1)), as mma.sync's C layout repeated along N.
// wgmma_tf32x<P, N> issues P = 3 products per k-step for split TF32 (lo.hi,
// hi.lo, hi.hi into the same accumulators; tf32.cuh) or P = 1 (hi.hi).
// A batch is wgmma_fence, the products, wgmma_commit; wgmma_wait<0> before
// the accumulators or a B operand's shared memory are touched again.
//
// TMA (cp.async.bulk.tensor): one thread asks for a whole box of a tensor
// described by a tensor map; the hardware writes it to shared memory,
// zeros where the box leaves the tensor, and counts its bytes off an
// mbarrier. With SWIZZLE_128B (boxes 128 bytes wide, destinations
// 1024-byte aligned) the 16-byte chunk c of 128-byte row q lands at chunk
// c ^ (q % 8): a warp's A fragment loads then hit 32 banks; with
// SWIZZLE_64B (boxes 64 bytes wide) chunk c of 64-byte row q at c ^ (q / 2
// % 4), bits 4-5 of the byte offset XOR bits 7-8. Contiguous
// blocks come in by cp.async.bulk (bulk_load) on the same barriers.
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, a
// driver function taken through cudaGetDriverEntryPoint(ByVersion), so the
// library links no libcuda; they reach the kernel as __grid_constant__
// parameters.
//
// mbarrier: a barrier in shared memory with an arrival count and a count of
// bytes in flight; a phase completes when both reach zero, and a waiter
// names the parity of the phase it waits for.
//
// Built with -DFNO_EMULATE, emulate/emu.h supplies the same functions on
// the CPU (a box copy with the same swizzle and zero fill, the products
// read through the descriptor, barriers with a phase).
#pragma once

#include "tf32.cuh"

#ifndef FNO_EMULATE
#include <cuda.h>  // CUtensorMap and its enums; the driver function comes by entry point

#include <cstring>

struct alignas(8) Mbar {
  uint64_t state;
};

__device__ __forceinline__ void mbar_init(Mbar* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(Mbar* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}
// One arrival that also announces `bytes` of copies that will complete on b.
__device__ __forceinline__ void mbar_arrive_expect_tx(Mbar* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}
// Until the phase of parity `parity` of b has completed. A wait that
// never ends (a fault in the kernel's bookkeeping) traps after some
// seconds, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(Mbar* b, int parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on b.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, Mbar* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}
// The box of `map` at coordinates (c0 innermost .. c3) into shared dst,
// completing on b.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, Mbar* b, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(b)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// This thread's writes to shared memory, visible to the async proxy (the
// operands wgmma reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barrier `id` (1-15; 0 is __syncthreads') over `threads` threads:
// named_sync waits for them all, named_arrive counts this thread's warp in
// and goes on. A kernel's producer never joins its consumers' barriers.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
#endif  // FNO_EMULATE

// Named barrier 1 over the `threads` consumer threads.
__device__ __forceinline__ void consumer_sync(int threads) { named_sync(1, threads); }

#ifndef FNO_EMULATE

// This warpgroup's registers a thread, down (dec) or up (inc) to N (24 to
// 256, a multiple of 8), every warp of it together; what one gives up, the
// others' inc takes. Compiled in only where the kernel's roles split in one
// branch that never rejoins.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N committed batches of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving the computation or use of a wgmma operand
// (an accumulator, an A register, a descriptor) across a fence, a commit
// or a wait: a register written between wgmma_fence and the product that
// reads it makes ptxas insert fences of its own and serialize the products.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint64_t& r) { asm volatile("" : "+l"(r)::"memory"); }

#define FNO_WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FNO_WG_D8(i) FNO_WG_D4(i), FNO_WG_D4(i + 4)
#define FNO_WG_D16(i) FNO_WG_D8(i), FNO_WG_D8(i + 8)
#define FNO_WG_D32(i) FNO_WG_D16(i), FNO_WG_D16(i + 16)

// d (N / 2 floats a thread) += A (registers a) . B (descriptor b), one
// m64nNk8 TF32 product of the warpgroup.
template <int N>
__device__ void wgmma_tf32(float* d, const uint32_t a[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : FNO_WG_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<24>(float* d, const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : FNO_WG_D8(0), FNO_WG_D4(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : FNO_WG_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<48>(float* d, const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : FNO_WG_D16(0), FNO_WG_D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : FNO_WG_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : FNO_WG_D32(0), FNO_WG_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FNO_WG_D4
#undef FNO_WG_D8
#undef FNO_WG_D16
#undef FNO_WG_D32

// A tiled tensor map of a float32 tensor of 4 dimensions (dims innermost
// first, byte strides of dims 1-3), boxes of `box` elements, a swizzle of
// `swizzle` bytes (128 or 64: box[0] floats fill it), zeros outside the
// tensor. Returns a CUDA error code. The last few maps are kept by their
// arguments: a rollout's steps reuse a few buffers, and each encoding is a
// driver call on every launch.
inline int encode_tensor_map_4d(CUtensorMap* map, const void* base, const uint64_t dims[4],
                                const uint64_t strides[3], const uint32_t box[4], int swizzle) {
  struct Entry {
    const void* base;
    uint64_t dims[4], strides[3];
    uint32_t box[4];
    int swizzle;
    CUtensorMap map;
  };
  static Entry kept[8];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = kept[i];
    if (e.base == base && e.swizzle == swizzle && !memcmp(e.dims, dims, sizeof e.dims) &&
        !memcmp(e.strides, strides, sizeof e.strides) && !memcmp(e.box, box, sizeof e.box)) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t s[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]}, unit[4] = {1, 1, 1, 1};
  if (swizzle != 128 && swizzle != 64) return cudaErrorInvalidValue;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), d, s, bx, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  Entry& e = kept[next];
  next = (next + 1) % 8;
  if (used < 8) ++used;
  e.base = base;
  e.swizzle = swizzle;
  memcpy(e.dims, dims, sizeof e.dims);
  memcpy(e.strides, strides, sizeof e.strides);
  memcpy(e.box, box, sizeof e.box);
  e.map = *map;
  return cudaSuccess;
}
#endif  // FNO_EMULATE

// fence_operand on a k-step's split A fragment.
__device__ __forceinline__ void fence_operands(uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  for (int i = 0; i < 4; ++i) {
    fence_operand(hi[i]);
    fence_operand(lo[i]);
  }
}

// A batch of products into the n accumulators d with the k-steps' split A
// registers hi, lo: begin fences the operands and issues wgmma_fence; end
// commits, waits for the batch and fences the accumulators.
template <int KS>
__device__ __forceinline__ void wgmma_batch_begin(float* d, int n, uint32_t (&hi)[KS][4],
                                                  uint32_t (&lo)[KS][4]) {
  for (int i = 0; i < n; ++i) fence_operand(d[i]);
  for (int ks = 0; ks < KS; ++ks) fence_operands(hi[ks], lo[ks]);
  wgmma_fence();
}
__device__ __forceinline__ void wgmma_batch_end(float* d, int n) {
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < n; ++i) fence_operand(d[i]);
}

// A shared-memory descriptor of a K-major B operand without swizzle (see
// the header): start p, LBO and SBO in bytes (multiples of 16).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

// d += A . B in P TF32 products: P = 3 is split TF32 (the small terms
// first), P = 1 the high halves alone; b_hi and b_lo describe B's planes.
template <int P, int N>
__device__ __forceinline__ void wgmma_tf32x(float* d, const uint32_t a_hi[4], const uint32_t a_lo[4],
                                            uint64_t b_hi, uint64_t b_lo) {
  static_assert(P == 1 || P == 3, "one TF32 product, or three (split TF32)");
  if (P == 3) {
    wgmma_tf32<N>(d, a_lo, b_hi);
    wgmma_tf32<N>(d, a_hi, b_lo);
  }
  wgmma_tf32<N>(d, a_hi, b_hi);
}
