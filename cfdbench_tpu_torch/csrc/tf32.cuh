// Split-TF32 products on Hopper's tensor cores, and cp.async staging.
//
// A float32 a is split into a_hi = tf32(a) (10 mantissa bits, rounded to
// nearest with ties away from zero, the low 13 bits zero) and a_lo = a -
// a_hi, exact in float32. The tensor cores read the top 19 bits of a TF32
// operand, so a_lo enters truncated, off by at most 2^-10 |a_lo| <= 2^-21
// |a| (rounding it too cost two instructions per value and a fifth of the
// forward DFT pass's time on an H100 80GB HBM3, for no change in the
// block's error).
// a*b is then a_hi*b_hi + a_hi*b_lo + a_lo*b_hi accumulated in float32;
// the dropped a_lo*b_lo is about 2^-22 |a*b|. Three mma.sync.m16n8k8 TF32
// products thus hold float32 accuracy at a third of the tensor cores' TF32
// rate (495 TFLOP/s dense on an H100 SXM's data sheet; about 320 TFLOP/s
// for mma.sync on an H100 80GB HBM3 at 700 W, scripts/bench_torch_kernels.py),
// above the 67 TFLOP/s of float32 FMA.
//
// Fragment layout of mma.m16n8k8 with .tf32 operands (lane = 4 g + t):
//   A (16 x 8, row): a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g)  b1 (t + 4, g)
//   C, D (16 x 8):   c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// The host builds constant operands already split and in this order
// (cfdbench_tpu_torch/ops/fno_kernels.py), so a lane reads its fragment
// with one 16-byte load.
#pragma once

#include "launch.cuh"

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

#ifndef FNO_EMULATE
// d += a * b, one m16n8k8 TF32 product accumulated in float32.
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies (16 bytes: both addresses 16-byte
// aligned; 4 bytes for rows whose width is not a multiple of 4 floats).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

// d += a * b in split TF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float d[4], const uint32_t a_hi[4],
                                           const uint32_t a_lo[4], const uint32_t b_hi[2],
                                           const uint32_t b_lo[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// A fragment from a row-major float32 tile in shared memory whose element
// (r, k) is at base[r * rs + k * ks], split in registers.
__device__ __forceinline__ void load_a_split(const float* base, int rs, int ks, int g, int t,
                                             uint32_t hi[4], uint32_t lo[4]) {
  split_tf32(base[g * rs + t * ks], hi[0], lo[0]);
  split_tf32(base[(g + 8) * rs + t * ks], hi[1], lo[1]);
  split_tf32(base[g * rs + (t + 4) * ks], hi[2], lo[2]);
  split_tf32(base[(g + 8) * rs + (t + 4) * ks], hi[3], lo[3]);
}

// A fragment already split by the host: 8 floats per lane (hi a0-a3, lo a0-a3).
__device__ __forceinline__ void load_a_frag(const float4* p, uint32_t hi[4], uint32_t lo[4]) {
  const float4 h = p[0], l = p[1];
  hi[0] = __float_as_uint(h.x); hi[1] = __float_as_uint(h.y);
  hi[2] = __float_as_uint(h.z); hi[3] = __float_as_uint(h.w);
  lo[0] = __float_as_uint(l.x); lo[1] = __float_as_uint(l.y);
  lo[2] = __float_as_uint(l.z); lo[3] = __float_as_uint(l.w);
}

// B fragment already split: 4 floats per lane (hi b0, hi b1, lo b0, lo b1).
__device__ __forceinline__ void load_b_frag(const float4* p, uint32_t hi[2], uint32_t lo[2]) {
  const float4 v = *p;
  hi[0] = __float_as_uint(v.x); hi[1] = __float_as_uint(v.y);
  lo[0] = __float_as_uint(v.z); lo[1] = __float_as_uint(v.w);
}
