// Fused FNO head for Hopper (sm_90a):
//   out = (GELU(x @ w1^T + b1) @ w2^T + b2) * mask
//
// Replaces: cfdbench_tpu/ops/pallas_fno.py::fused_fno_head (body
// `_head_kernel`), the TPU kernel that keeps the (B, H, W, 128) fc1
// intermediate in VMEM.
//
// What bounds it on this card: at the flagship shape (B=128, 64x64,
// C=32, 128 hidden, 2 outputs) it reads x (67 MB) and the mask (2 MB) and
// writes 4 MB, 22 us at 3.35 TB/s. fc1's 2.15 G multiply-adds in split
// TF32, three TF32 products each at the card's 495 TFLOP/s, take 26 us,
// and fc2's 0.13 G on the CUDA cores 4 us at 67 TFLOP/s: the bound is the
// operations, 30 us. The epilogue has a floor of its own on the CUDA
// cores, which that bound leaves out: each of its 67.1 M hidden units takes
// 16.5 SASS instructions from accumulator to sum (bias, GELU, fc2; the
// probe in scripts/bench_torch_kernels.py), 33 us at 132 SMs x 128 lanes
// x 1980 MHz. With erff in place of the rational erf the kernel was slower
// (PERF.md section 6).
//
// Two routes, chosen by the shape before a launch (fno_head_route), never
// after a failure; one launch per group of at most 8 outputs, each
// recomputing fc1 (the FNO's 2 outputs are a compile-time count).
//
// The Hopper route, where C is a multiple of 4 (TMA's 16-byte strides) and
// its shared memory fits (every width the FNO runs): fno_head_hopper_kernel,
// persistent, one block an SM of three consumer warpgroups and a producer
// warpgroup, one thread of which issues the loads. A tile is 64 pixels
// (wgmma's M); a unit is a tile's 32 channels, one TMA box of x viewed as
// an (n, C) tensor (64 rows of 128 bytes,
// 128-byte swizzle, zeros past C and n), which the producer keeps in flight
// through a ring of mbarrier slots. fc1 is one m64n128k8 wgmma per k-step
// and TF32 product (RS form): A is the tile's rows, read from the box and
// split in registers once a unit (once a tile at C <= 32); B is w1^T as
// K-major hi and lo planes in shared memory, split once a block where they
// fit with the ring (C up to 128 at 128 hidden units), else split once a
// call by fno_head_split_kernel into device scratch and streamed by
// cp.async.bulk beside x a unit at a time (C 160, 256). The accumulators
// hold all 128 hidden units (64 floats a thread), so the products of a
// tile are one batch; a hidden width past 128 runs in chunks of 128, one
// under 128 is padded with zeros, and its GELU and fc2 run only on the
// 32-unit groups it fills. The warpgroups take the block's tiles in turn,
// and named barriers pass the tensor cores round them (FlashAttention-3's
// ping-pong, over three): a warpgroup issues its tile's products in its
// turn and hands the turn on, then runs the epilogue on its accumulators
// while the others' products run: b1 (scaled by 1/sqrt 2), GELU with the
// TPU kernel's rational erf (head_gelu) and the fc2 FMAs against w2 / sqrt
// 2 in shared memory, branch-free over the tile before any store, the sum
// over the four lanes that share a pixel, b2 and the mask (read by the
// storing lanes as the products run: it may sit at any 4-byte offset of
// the caller's tensor, so TMA's 16-byte rule is not imposed on it). Three
// warpgroups, not two: the epilogue is latency-bound at one warp a
// scheduler; four, at 120 registers a thread, spill and serialize the
// products. The block launches at 128 registers a thread; setmaxnreg
// takes the producer warpgroup down to 24 and the consumers up to 160, so
// that the 8-output epilogue's sums fit beside the 64 accumulators.
//
// The sm_80 route, at the other shapes (and on request, to time both):
// mma.sync and cp.async (tf32.cuh). A persistent block walks tiles of 128
// pixels, staged one tile ahead; each warp owns 16 pixels and computes
// their hidden units 64 at a time in registers. Where w1 and two tiles of x
// fit shared memory (C up to 104 at 128 hidden units), w1 is split once per
// block into fragment order (fno_head_kernel); wider, a unit of work is
// (tile, 64 hidden units, 64 channels), whose columns of x and rows of w1
// come raw through a two-slot cp.async ring, w1 split as its fragments are
// read (fno_head_streamed_kernel).
//
// In TF32 mode (P = 1: --matmul_precision high) fc1 is one TF32 product a
// k-step on either route; fc2 stays float32 FMA.
//
// Measured at the flagship shape on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/bench_torch_kernels.py): 0.0786 ms a call by torch.profiler,
// 0.0812-0.0817 by CUDA events against 0.1731-0.1749 ms on the sm_80 route
// in the same turns; TF32 mode 0.0657 ms (events 0.0681-0.0684 against
// 0.1441-0.1448). Width 256 (w1 streamed) about 0.37 ms, B=8 on 512x512 about 0.32 ms
// (chip_smoke.py phase 17a). A call through the registered operator
// spends about as long on the host as this kernel on the card.

#include "hopper.cuh"

namespace {

constexpr int kHeadThreads = 256;
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kTile = kHeadWarps * 16;  // pixels per tile: one 16-row tile per warp
constexpr int kChunk = 8;               // hidden n-tiles (64 units) per accumulator pass
constexpr int kMaxOut = 8;              // outputs per launch
// Streamed kernel: fc1's k-steps per channel chunk (64 channels), and the
// row stride of its staged x and w1 (4 mod 8: conflict-free fragment loads).
constexpr int kHeadKS = 8;
constexpr int kHeadSx = kHeadKS * 8 + 4;
constexpr int kHeadSlot = (kTile + kChunk * 8) * kHeadSx;  // floats: x's pixels, then w1's rows

// The epilogue of 64 hidden units (n-tiles nc .. nc + kChunk) of a warp's
// 16 pixels: s[o][r] += GELU(acc + b1) . w2[o] for this lane's part of
// pixel row g + 8 r. b1 and w2 are read through `bias` and `w2at`.
template <int NOUT, int OUTS, class Bias, class W2>
__device__ __forceinline__ void head_epilogue(const float (&acc)[kChunk][4], float (&s)[OUTS][2],
                                              int nc, int nth, int n_out, int t, Bias bias,
                                              W2 w2at) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (nc + j < nth) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = (nc + j) * 8 + 2 * t + (i & 1);
        const float hdn = gelu_erf(acc[j][i] + bias(col));
#pragma unroll
        for (int o = 0; o < OUTS; ++o) {
          if (NOUT || o < n_out) s[o][i >> 1] = fmaf(hdn, w2at(o, col), s[o][i >> 1]);
        }
      }
    }
  }
}

// The four lanes of a group hold disjoint hidden units of the same pixels:
// sum them and write the tile's outputs (row stride ldo), masked.
template <int NOUT, int OUTS>
__device__ __forceinline__ void head_store(float (&s)[OUTS][2], const float* b2,
                                           const float* __restrict__ mask, float* __restrict__ out,
                                           long long p0, long long n, int n_out, int ldo, int g,
                                           int t) {
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[o][r] += __shfl_xor_sync(0xffffffffu, s[o][r], 1);
      s[o][r] += __shfl_xor_sync(0xffffffffu, s[o][r], 2);
    }
  }
  if (t < 2) {
    const long long p = p0 + g + 8 * t;
    if (p < n) {
      const float mk = mask[p];
#pragma unroll
      for (int o = 0; o < OUTS; ++o) {
        if (NOUT || o < n_out) out[p * ldo + o] = ((t ? s[o][1] : s[o][0]) + b2[o]) * mk;
      }
    }
  }
}

// NOUT: the output count when it is fixed at compile time (the FNO's 2),
// or 0 for any count up to kMaxOut, checked at run time. w1 resident.
template <int NOUT, int P>
__global__ void __launch_bounds__(kHeadThreads) fno_head_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ mask,
    float* __restrict__ out, long long n, int C, int hidden, int n_out, int ldo) {
  constexpr int OUTS = NOUT ? NOUT : kMaxOut;
  FNO_DYNAMIC_SMEM(float4, smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kc = ceil_div(C, 8), kp = kc * 8, sx = kp + 4;  // sx = 4 mod 8: conflict-free A loads
  const int nth = ceil_div(hidden, 8), hp = nth * 8;
  float4* w1s = smem4;                                             // kc * nth * 32
  float* b1s = reinterpret_cast<float*>(w1s + kc * nth * 32);      // hp
  float* w2s = b1s + hp;                                           // n_out * hp
  float* b2s = w2s + n_out * hp;                                   // kMaxOut
  float* xs = b2s + kMaxOut;                                       // 2 x [pixel][sx]

  // w1^T as split B fragments: element (c, j) = w1[j, c].
  for (int i = tid; i < kc * nth * 32; i += kHeadThreads) {
    const int l = i % 32, nt = (i / 32) % nth, ks = i / (32 * nth);
    const int j = nt * 8 + (l >> 2), c = ks * 8 + (l & 3);
    const float v0 = j < hidden && c < C ? w1[(size_t)j * C + c] : 0.f;
    const float v1 = j < hidden && c + 4 < C ? w1[(size_t)j * C + c + 4] : 0.f;
    uint32_t hi0, lo0, hi1, lo1;
    split_tf32(v0, hi0, lo0);
    split_tf32(v1, hi1, lo1);
    w1s[i] = make_float4(__uint_as_float(hi0), __uint_as_float(hi1), __uint_as_float(lo0),
                         __uint_as_float(lo1));
  }
  for (int i = tid; i < hp; i += kHeadThreads) b1s[i] = i < hidden ? b1[i] : 0.f;
  for (int i = tid; i < n_out * hp; i += kHeadThreads) {
    const int o = i / hp, j = i % hp;
    w2s[i] = j < hidden ? w2[(size_t)o * hidden + j] : 0.f;
  }
  for (int i = tid; i < kMaxOut; i += kHeadThreads) b2s[i] = i < n_out ? b2[i] : 0.f;

  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // Pixels tile * kTile .. + kTile into dst, zero outside x.
  auto stage = [&](long long tile, float* dst) {
    const long long p0 = tile * kTile;
    if (vec) {
      const int q_n = kp / 4;
      Walk3 ix(tid, kHeadThreads, q_n, kTile);
      for (int i = tid; i < kTile * q_n; i += kHeadThreads, ix.next()) {
        const int q = ix.i0, r = ix.i1;
        float* d = dst + r * sx + 4 * q;
        if (p0 + r < n && 4 * q < C) {
          cp_async16(d, x + (p0 + r) * C + 4 * q);
        } else {
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      Walk3 ix(tid, kHeadThreads, kp, kTile);
      for (int i = tid; i < kTile * kp; i += kHeadThreads, ix.next()) {
        const int c = ix.i0, r = ix.i1;
        float* d = dst + r * sx + c;
        if (p0 + r < n && c < C) {
          cp_async4(d, x + (p0 + r) * C + c);
        } else {
          *d = 0.f;
        }
      }
    }
    cp_async_commit();
  };

  const long long n_tiles = (n + kTile - 1) / kTile;
  long long tile = blockIdx.x;
  if (tile < n_tiles) stage(tile, xs);
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles) {
      stage(next, xs + ((it + 1) & 1) * kTile * sx);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile staged (and, the first time, the weights)
    const float* xa = xs + (it & 1) * kTile * sx + warp * 16 * sx;
    // s[o][r]: this lane's part of output o for pixel row g + 8 r.
    float s[OUTS][2];
#pragma unroll
    for (int o = 0; o < OUTS; ++o) s[o][0] = s[o][1] = 0.f;
    for (int nc = 0; nc < nth; nc += kChunk) {
      float acc[kChunk][4];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      for (int ks = 0; ks < kc; ++ks) {
        uint32_t ahi[4], alo[4];
        load_a_split(xa + ks * 8, sx, 1, g, t, ahi, alo);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (nc + j < nth) {
            uint32_t bhi[2], blo[2];
            load_b_frag(w1s + (ks * nth + nc + j) * 32 + lane, bhi, blo);
            mma_tf32x<P>(acc[j], ahi, alo, bhi, blo);
          }
        }
      }
      head_epilogue<NOUT>(acc, s, nc, nth, n_out, t, [&](int col) { return b1s[col]; },
                          [&](int o, int col) { return w2s[o * hp + col]; });
    }
    head_store<NOUT>(s, b2s, mask, out, tile * kTile + warp * 16, n, n_out, ldo, g, t);
    __syncthreads();  // every read of this x buffer done before it is refilled
  }
}

// The same head where w1 and two tiles of x do not fit shared memory: a
// unit is (tile, 64 hidden units, 64 channels); its columns of x and rows
// of w1 come raw into a ring slot two units ahead of the products, w1 split
// as its fragments are read; b1 and w2 are read from device memory (L1) in
// the epilogue.
template <int NOUT, int P>
__global__ void __launch_bounds__(kHeadThreads) fno_head_streamed_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ mask,
    float* __restrict__ out, long long n, int C, int hidden, int n_out, int ldo) {
  constexpr int OUTS = NOUT ? NOUT : kMaxOut;
  FNO_DYNAMIC_SMEM(float4, smem4);
  float* slots = reinterpret_cast<float*>(smem4);  // 2 x ([kTile][kHeadSx] x, [64][kHeadSx] w1)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kc = ceil_div(C, 8), n_cc = ceil_div(kc, kHeadKS);
  const int nth = ceil_div(hidden, 8), n_hc = ceil_div(nth, kChunk);
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int per_tile = n_hc * n_cc;
  const long long n_units = my_tiles * per_tile;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w1) % 16 == 0;

  // Unit u: pixels of its tile and hidden rows of its chunk, its 64
  // channels, into slot u % 2; zero outside x and w1. Always exactly one
  // commit group.
  auto stage = [&](long long u) {
    if (u < n_units) {
      const long long p0 = (blockIdx.x + (u / per_tile) * gridDim.x) * kTile;
      const int j0 = (int)(u % per_tile / n_cc) * kChunk * 8, c0 = (int)(u % n_cc) * kHeadKS * 8;
      float* xd = slots + (u & 1) * kHeadSlot;  // w1's rows follow x's
      if (vec) {
        constexpr int q_n = kHeadKS * 2;
        Walk3 ix(tid, kHeadThreads, q_n, kTile + kChunk * 8);
        for (int i = tid; i < (kTile + kChunk * 8) * q_n; i += kHeadThreads, ix.next()) {
          const int q = ix.i0, r = ix.i1, c = c0 + 4 * q;
          float* d = xd + r * kHeadSx + 4 * q;
          if (r < kTile ? p0 + r < n && c < C : j0 + r - kTile < hidden && c < C) {
            cp_async16(d, r < kTile ? x + (p0 + r) * C + c : w1 + (size_t)(j0 + r - kTile) * C + c);
          } else {
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      } else {
        constexpr int c_n = kHeadKS * 8;
        Walk3 ix(tid, kHeadThreads, c_n, kTile + kChunk * 8);
        for (int i = tid; i < (kTile + kChunk * 8) * c_n; i += kHeadThreads, ix.next()) {
          const int r = ix.i1, c = c0 + ix.i0;
          float* d = xd + r * kHeadSx + ix.i0;
          if (r < kTile ? p0 + r < n && c < C : j0 + r - kTile < hidden && c < C) {
            cp_async4(d, r < kTile ? x + (p0 + r) * C + c : w1 + (size_t)(j0 + r - kTile) * C + c);
          } else {
            *d = 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };

  float s[OUTS][2];
  float acc[kChunk][4];
  stage(0);
  stage(1);
  for (long long u = 0; u < n_units; ++u) {
    const int hc = (int)(u % per_tile / n_cc), cc = (int)(u % n_cc);
    cp_async_wait<1>();
    __syncthreads();  // unit u staged
    if (hc == 0 && cc == 0) {
#pragma unroll
      for (int o = 0; o < OUTS; ++o) s[o][0] = s[o][1] = 0.f;
    }
    if (cc == 0) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
    const int nc = hc * kChunk, ks_n = min(kHeadKS, kc - cc * kHeadKS);
    const float* xa = slots + (u & 1) * kHeadSlot + warp * 16 * kHeadSx;
    const float* wb = slots + (u & 1) * kHeadSlot + kTile * kHeadSx;
    for (int ks = 0; ks < ks_n; ++ks) {
      uint32_t ahi[4], alo[4];
      load_a_split(xa + ks * 8, kHeadSx, 1, g, t, ahi, alo);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (nc + j < nth) {
          // b0 (k = t, n = g) is w1[j0 + 8 j + g, c0 + 8 ks + t]; b1 four channels on.
          const float* wv = wb + (j * 8 + g) * kHeadSx + ks * 8 + t;
          uint32_t bhi[2], blo[2];
          split_tf32(wv[0], bhi[0], blo[0]);
          split_tf32(wv[4], bhi[1], blo[1]);
          mma_tf32x<P>(acc[j], ahi, alo, bhi, blo);
        }
      }
    }
    if (cc == n_cc - 1) {
      head_epilogue<NOUT>(acc, s, nc, nth, n_out, t,
                          [&](int col) { return col < hidden ? __ldg(b1 + col) : 0.f; },
                          [&](int o, int col) {
                            return col < hidden ? __ldg(w2 + (size_t)o * hidden + col) : 0.f;
                          });
      if (hc == n_hc - 1) {
        const long long p0 = (blockIdx.x + (u / per_tile) * gridDim.x) * kTile;
        head_store<NOUT>(s, b2, mask, out, p0 + warp * 16, n, n_out, ldo, g, t);
      }
    }
    __syncthreads();  // every read of this slot done before it is refilled
    stage(u + 2);
  }
  cp_async_wait<0>();
}

// Shared memory of the resident head kernel (two tiles of x).
size_t head_smem(int C, int hidden, int n_out) {
  const size_t kc = ceil_div(C, 8), nth = ceil_div(hidden, 8), hp = nth * 8;
  return 16 * kc * nth * 32 +
         sizeof(float) * (hp + n_out * hp + kMaxOut + 2 * kTile * (kc * 8 + 4));
}

// One launch for outputs o0 .. o0 + n_out - 1 (n_out <= kMaxOut) of ldo,
// fc1 in P TF32 products.
template <int NOUT, int P>
int launch_head(const float* x, const float* w1, const float* b1,
                const float* w2, const float* b2, const float* mask,
                float* out, long long n, int C, int hidden, int n_out, int ldo,
                cudaStream_t stream) {
  const bool resident = head_smem(C, hidden, n_out) <= kMaxDynamicSmem;
  const size_t smem = resident ? head_smem(C, hidden, n_out) : sizeof(float) * 2 * kHeadSlot;
  const auto kernel = resident ? fno_head_kernel<NOUT, P> : fno_head_streamed_kernel<NOUT, P>;
  cudaError_t err = allow_dynamic_smem((const void*)kernel, smem);
  if (err) return err;
  int blocks = 0;
  if ((err = persistent_blocks(kernel, kHeadThreads, smem, (n + kTile - 1) / kTile, &blocks)))
    return err;
  FNO_LAUNCH(kernel, (unsigned)blocks, kHeadThreads, smem, stream)(
      x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out, ldo);
  return cudaGetLastError();
}


// The Hopper route (fno_head_hopper_kernel). kHopTile, kHopKc and kHopN
// fix the units' layout; the split planes of a unit are
// [2 (hi, lo)][kHopKc / 4][kHopN][4] floats: hopper.cuh's K-major B layout,
// LBO kHopN * 16 bytes, SBO 128.
constexpr int kHopWGs = 3;                         // consumer warpgroups
constexpr int kHopConsumers = kHopWGs * 128;
constexpr int kHopThreads = kHopConsumers + 128;   // and a producer warpgroup
// Registers a thread: 512 threads launch at 128 (ptxas counts a block in
// whole warpgroups); the producer warpgroup gives all but 24 of its up,
// and the consumers take them, 160 each (3 x 128 x 160 + 128 x 24 <= 65536).
constexpr int kHopProducerRegs = 24, kHopConsumerRegs = 160;
constexpr int kHopTile = 64;                       // pixels a tile: wgmma's M
constexpr int kHopKc = 32;                         // channels a unit: a 128-byte box row
constexpr int kHopN = 128;                         // hidden units an accumulator set
constexpr int kHopBox = kHopTile * kHopKc * 4;     // bytes of a unit's x box: 8 KB
constexpr int kHopPlanes = 2 * kHopKc * kHopN * 4;  // bytes of a unit's w1 planes: 32 KB
constexpr int kHopLbo = kHopN * 16;
constexpr int kHopTurn = 2;        // named barriers 2 ..: each consumer warpgroup's turn,
constexpr int kHopTurnThreads = 256;  // between it and the warpgroup before it
constexpr float kRsqrt2 = 0.70710678118654752f;

// Slots of the ring and bytes of a slot: an x box, and the unit's w1 planes
// when they stream.
template <bool STREAM>
struct HopRing {
  static constexpr int slots = STREAM ? 4 : 8;
  static constexpr int slot = kHopBox + (STREAM ? kHopPlanes : 0);
};

// Element i (of n_hc n_kc kHopPlanes / 8) of w1's split planes, in unit
// order: both halves of w1[j, c] (zero past hidden and C) for chunk (hc, kc)
// = (i / 4096) / n_kc, % n_kc, c / 4 = (i / 512) % 8, j = (i / 4) % 128.
__device__ __forceinline__ void split_plane_element(const float* __restrict__ w1,
                                                    float* planes, int i, int C, int hidden,
                                                    int n_kc) {
  const int cm = i & 3, j = (i >> 2) & (kHopN - 1), c4 = (i >> 9) & 7, chunk = i >> 12;
  const int row = chunk / n_kc * kHopN + j, c = chunk % n_kc * kHopKc + c4 * 4 + cm;
  const float v = row < hidden && c < C ? w1[(size_t)row * C + c] : 0.f;
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  float* p = planes + (size_t)chunk * (kHopPlanes / 4) + (i & 4095);
  p[0] = __uint_as_float(hi);
  p[4096] = __uint_as_float(lo);
}

// The streamed kernel's w1 planes, once a call, into device scratch.
__global__ void __launch_bounds__(256) fno_head_split_kernel(const float* __restrict__ w1,
                                                             float* __restrict__ planes, int C,
                                                             int hidden, int n_kc, int total) {
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total; i += gridDim.x * 256)
    split_plane_element(w1, planes, i, C, hidden, n_kc);
}

// u (1 + erf(u)), which is sqrt 2 GELU(sqrt 2 u). erf is the TPU kernel's
// own, Abramowitz-Stegun 7.1.26 (one reciprocal, one exp; absolute error
// under 1.5e-7, far inside the head's 1e-5 gate against the plain
// version's exact erf), taken at |u|, since u erf(u) = |u| erf(|u|).
__device__ __forceinline__ float head_gelu(float u) {
  // 1 / (1 + 0.3275911 |u|) and exp(-u^2) = 2^(-u^2 log2 e), each one
  // special-function instruction without denormal handling.
  const float t = rcp_approx(fmaf(0.3275911f, fabsf(u), 1.f));
  float p = fmaf(t, 1.061405429f, -1.453152027f);
  p = fmaf(p, t, 1.421413741f);
  p = fmaf(p, t, -0.284496736f);
  p = fmaf(p, t, 0.254829592f) * t;
  return fmaf(fabsf(u), fmaf(-p, ex2_approx(u * -1.4426950408889634f * u), 1.f), u);
}

// The epilogue of one chunk of 128 hidden units on a warpgroup's 64 x 128
// accumulators: s[o][r] += sum over this lane's hidden units of
// GELU(h) w2[o] for its pixel rows g (r 0) and g + 8 (r 1), h = acc + b1.
// With u = h / sqrt 2, GELU(h) = (u + u erf(u)) / sqrt 2, so b1c and w2c
// hold b1 and w2 over sqrt 2. acc[4 j + i]: row g + 8 (i >> 1), hidden unit
// 8 j + 2 t + (i & 1) (hopper.cuh). FULL: all 128 units, branch-free; else
// the `groups` groups of 32 units that the hidden width fills (a uniform
// branch a group).
template <int OUTS, bool FULL>
__device__ __forceinline__ void hopper_epilogue(const float (&acc)[kHopN / 2],
                                                float (&s)[OUTS][2], const float* b1c,
                                                const float* w2c, int hp, int groups, int t) {
#pragma unroll
  for (int q = 0; q < kHopN / 32; ++q) {
    if (FULL || q < groups) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj, col = 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(b1c + col);
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float u = fmaf(acc[4 * j + i], kRsqrt2, (i & 1) ? bb.y : bb.x);
          v[i] = head_gelu(u);
        }
#pragma unroll
        for (int o = 0; o < OUTS; ++o) {
          const float2 w = *reinterpret_cast<const float2*>(w2c + o * hp + col);
          s[o][0] = fmaf(v[1], w.y, fmaf(v[0], w.x, s[o][0]));
          s[o][1] = fmaf(v[3], w.y, fmaf(v[2], w.x, s[o][1]));
        }
      }
    }
  }
}

// x (n, C) through `xmap` (boxes of kHopKc channels x kHopTile pixels,
// 128-byte swizzle); w1 (hidden, C), split here (resident) or `planes`
// (STREAM: fno_head_split_kernel's); b1, w2 (n_out, hidden), b2, mask (n,);
// out (n, ldo), outputs 0 .. n_out - 1 <= OUTS (the rest of w2 and b2 read
// as zeros).
template <int OUTS, int P, bool STREAM>
__global__ void __launch_bounds__(kHopThreads, 1) fno_head_hopper_kernel(
    const __grid_constant__ CUtensorMap xmap, const float* __restrict__ w1,
    const float* __restrict__ planes, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ mask,
    float* __restrict__ out, int n, int C, int hidden, int n_out, int ldo) {
  using Ring = HopRing<STREAM>;
  FNO_DYNAMIC_SMEM(float4, smem4);
  // The warp index through a shuffle, which the compiler knows is uniform
  // across the warp: wgmma under a branch it cannot prove uniform is
  // serialized.
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_kc = ceil_div(C, kHopKc), n_hc = ceil_div(hidden, kHopN), hp = n_hc * kHopN;
  const int units = n_hc * n_kc, n_tiles = ceil_div(n, kHopTile);

  char* raw = reinterpret_cast<char*>(smem4);
  char* ring = raw + (1024 - smem_addr(raw) % 1024) % 1024;  // the swizzle's alignment
  float* w1s = reinterpret_cast<float*>(ring + Ring::slots * Ring::slot);  // resident planes
  float* b1c = w1s + (STREAM ? 0 : units * (kHopPlanes / 4));               // hp
  float* w2c = b1c + hp;                                                    // OUTS x hp
  float* b2s = w2c + OUTS * hp;                                             // OUTS
  Mbar* full = reinterpret_cast<Mbar*>(b2s + OUTS);
  Mbar* empty = full + Ring::slots;

  for (int i = tid; i < hp; i += kHopThreads) b1c[i] = i < hidden ? b1[i] * kRsqrt2 : 0.f;
  for (int i = tid; i < OUTS * hp; i += kHopThreads) {
    const int o = i / hp, j = i % hp;
    w2c[i] = o < n_out && j < hidden ? w2[(size_t)o * hidden + j] * kRsqrt2 : 0.f;
  }
  for (int i = tid; i < OUTS; i += kHopThreads) b2s[i] = i < n_out ? b2[i] : 0.f;
  if (!STREAM) {
    for (int i = tid; i < units * (kHopPlanes / 8); i += kHopThreads)
      split_plane_element(w1, w1s, i, C, hidden, n_kc);
  }
  if (tid == 0) {
    for (int s = 0; s < Ring::slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the four warps of the warpgroup that read the slot
    }
    fence_mbar_init();
  }
  fence_proxy_async();  // the split planes, read by wgmma
  __syncthreads();

  if (warp >= kHopConsumers / 32) {
    // Producer: one thread issues every unit of the block's tiles, in the
    // order the consumers' turns take them.
    setmaxnreg_dec<kHopProducerRegs>();
    if (warp == kHopConsumers / 32 && lane == 0) {
      int u = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int hc = 0; hc < n_hc; ++hc) {
          for (int kc = 0; kc < n_kc; ++kc, ++u) {
            const int slot = u % Ring::slots;
            mbar_wait(&empty[slot], (u / Ring::slots & 1) ^ 1);
            char* dst = ring + slot * Ring::slot;
            mbar_arrive_expect_tx(&full[slot], Ring::slot);
            tma_load_4d(dst, &xmap, &full[slot], kc * kHopKc, tile * kHopTile, 0, 0);
            if (STREAM) {
              bulk_load(dst + kHopBox, planes + (size_t)(hc * n_kc + kc) * (kHopPlanes / 4),
                        kHopPlanes, &full[slot]);
            }
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes the block's tiles wg, wg + kHopWGs, ...;
  // warp wq of it owns rows 16 wq .. 16 wq + 15 of each tile. The turn on
  // the tensor cores goes round the warpgroups in that order.
  setmaxnreg_inc<kHopConsumerRegs>();
  const int wg = warp >> 2, wq = warp & 3;
  if (wg == kHopWGs - 1) named_arrive(kHopTurn, kHopTurnThreads);  // warpgroup 0's turn first
  for (int pos = wg;; pos += kHopWGs) {
    const int tile = blockIdx.x + pos * gridDim.x;
    if (tile >= n_tiles) break;
    const int row = tile * kHopTile + 16 * wq + g;  // this thread's rows: row, row + 8
    float mk = 0.f;
    if (t < 2 && row + 8 * t < n) mk = __ldg(mask + row + 8 * t);
    float s[OUTS][2];
#pragma unroll
    for (int o = 0; o < OUTS; ++o) s[o][0] = s[o][1] = 0.f;
    named_sync(kHopTurn + wg, kHopTurnThreads);  // this warpgroup's turn on the tensor cores
    for (int hc = 0; hc < n_hc; ++hc) {
      float acc[kHopN / 2];
#pragma unroll
      for (int i = 0; i < kHopN / 2; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < n_kc; ++kc) {
        const int u = pos * units + hc * n_kc + kc, slot = u % Ring::slots;
        const char* xs = ring + slot * Ring::slot;
        // B: the unit's planes, in the slot or resident; a k-step of 8
        // channels is two LBOs on.
        uint64_t bh[4], bl[4];
        const uint64_t b0 = smem_desc(STREAM ? (const void*)(xs + kHopBox)
                                             : (const void*)(w1s + (size_t)(hc * n_kc + kc) *
                                                                       (kHopPlanes / 4)),
                                      kHopLbo, 128);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          bh[ks] = b0 + ((uint64_t)ks * 2 * kHopLbo >> 4);
          bl[ks] = bh[ks] + (kHopPlanes / 2 >> 4);
          fence_operand(bh[ks]);
          fence_operand(bl[ks]);
        }
        mbar_wait(&full[slot], u / Ring::slots & 1);
        // A: rows q of the box, channels 8 ks + t (+ 4), un-swizzled.
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = 16 * wq + g + 8 * (i & 1), c = ks * 8 + t + 4 * (i >> 1);
            const float v = *reinterpret_cast<const float*>(xs + ((q * 128 + c * 4) ^ ((q & 7) << 4)));
            split_tf32(v, ahi[ks][i], alo[ks][i]);
          }
        }
        if (!STREAM) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[slot]);
        }
        wgmma_batch_begin(acc, kHopN / 2, ahi, alo);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_tf32x<P, kHopN>(acc, ahi[ks], alo[ks], bh[ks], bl[ks]);
        wgmma_commit();
        // The tile's last products issued: the next warpgroup's turn.
        if (hc == n_hc - 1 && kc == n_kc - 1) {
          named_arrive(kHopTurn + (wg + 1) % kHopWGs, kHopTurnThreads);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kHopN / 2; ++i) fence_operand(acc[i]);
        if (STREAM) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[slot]);
        }
      }
      const int groups = ceil_div(min(hidden - hc * kHopN, kHopN), 32);
      if (groups == kHopN / 32) {
        hopper_epilogue<OUTS, true>(acc, s, b1c + hc * kHopN, w2c + hc * kHopN, hp, groups, t);
      } else {
        hopper_epilogue<OUTS, false>(acc, s, b1c + hc * kHopN, w2c + hc * kHopN, hp, groups, t);
      }
    }
    // The four lanes of a group hold disjoint hidden units of the same
    // rows: sum them; lane t < 2 writes row + 8 t.
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[o][r] += __shfl_xor_sync(0xffffffffu, s[o][r], 1);
        s[o][r] += __shfl_xor_sync(0xffffffffu, s[o][r], 2);
      }
    }
    if (t < 2 && row + 8 * t < n) {
      const size_t p = (size_t)(row + 8 * t);
#pragma unroll
      for (int o = 0; o < OUTS; ++o) {
        if (o < n_out) out[p * ldo + o] = ((t ? s[o][1] : s[o][0]) + b2s[o]) * mk;
      }
    }
  }
}

// The Hopper route's shared memory: the ring (and, resident, w1's planes),
// b1, w2 and b2 scaled, the barriers, the slack that aligns the ring.
size_t hopper_head_smem(int C, int hidden, bool stream) {
  const size_t units = (size_t)ceil_div(C, kHopKc) * ceil_div(hidden, kHopN);
  const size_t hp = (size_t)ceil_div(hidden, kHopN) * kHopN;
  const size_t ring = stream ? (size_t)HopRing<true>::slots * HopRing<true>::slot
                             : (size_t)HopRing<false>::slots * HopRing<false>::slot +
                                   units * kHopPlanes;
  const size_t slots = stream ? HopRing<true>::slots : HopRing<false>::slots;
  return 1024 + ring + sizeof(float) * (hp + kMaxOut * hp + kMaxOut) + 2 * slots * sizeof(Mbar);
}

// Whether the Hopper route takes C and hidden: C a multiple of 4 (TMA's
// 16-byte strides) and the ring, resident or streamed, in a block.
bool hopper_head_takes(int C, int hidden) {
  return C % 4 == 0 && hopper_head_smem(C, hidden, true) <= kMaxDynamicSmem;
}
bool hopper_head_streams(int C, int hidden) {
  return hopper_head_smem(C, hidden, false) > kMaxDynamicSmem;
}

// One Hopper launch for outputs o0 .. o0 + n_out - 1 (n_out <= OUTS) of
// ldo, fc1 in P TF32 products.
template <int OUTS, int P, bool STREAM>
int launch_head_hopper(const float* x, const float* w1, const float* planes, const float* b1,
                       const float* w2, const float* b2, const float* mask, float* out, int n,
                       int C, int hidden, int n_out, int ldo, cudaStream_t stream) {
  const auto kernel = fno_head_hopper_kernel<OUTS, P, STREAM>;
  const size_t smem = hopper_head_smem(C, hidden, STREAM);
  cudaError_t err = allow_dynamic_smem((const void*)kernel, smem);
  if (err) return err;
  CUtensorMap xmap;
  const uint64_t bytes = (uint64_t)n * C * 4;
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)n, 1, 1};
  const uint64_t strides[3] = {(uint64_t)C * 4, bytes, bytes};
  const uint32_t box[4] = {kHopKc, kHopTile, 1, 1};
  if ((err = (cudaError_t)encode_tensor_map_4d(&xmap, x, dims, strides, box, 128))) return err;
  int blocks = 0;
  if ((err = persistent_blocks(kernel, kHopThreads, smem, ceil_div(n, kHopTile), &blocks)))
    return err;
  FNO_LAUNCH(kernel, (unsigned)blocks, kHopThreads, smem, stream)(
      xmap, w1, planes, b1, w2, b2, mask, out, n, C, hidden, n_out, ldo);
  return cudaGetLastError();
}

// Floats of w1's split planes that the streamed Hopper kernel reads.
size_t hopper_head_planes(int C, int hidden) {
  return (size_t)ceil_div(C, kHopKc) * ceil_div(hidden, kHopN) * (kHopPlanes / 4);
}

}  // namespace

extern "C" {

// Null when a route takes these widths (fno_head_route), else why none does.
const char* fno_head_unsupported(int C, int hidden, int n_out) {
  static thread_local char why[160];
  if (C >= 1 && hidden >= 1 && n_out >= 1) return nullptr;
  snprintf(why, sizeof why, "it takes positive widths and output counts, got C=%d, hidden=%d, "
           "outputs=%d", C, hidden, n_out);
  return why;
}

// The route the head takes at these widths, by the shape alone: bit 0 set,
// the Hopper route (wgmma fed by TMA), else the sm_80-style one (mma.sync,
// cp.async), which takes C not a multiple of 4; bit 1 set, w1 streams (the
// Hopper route's planes split into scratch, fno_head_scratch; the sm_80
// route's fno_head_streamed_kernel). -1 for widths no route takes.
int fno_head_route(int C, int hidden, int n_out) {
  if (fno_head_unsupported(C, hidden, n_out)) return -1;
  if (hopper_head_takes(C, hidden)) return 1 | (hopper_head_streams(C, hidden) ? 2 : 0);
  return head_smem(C, hidden, n_out < kMaxOut ? n_out : kMaxOut) <= kMaxDynamicSmem ? 0 : 2;
}

// Floats of device scratch that fno_head_forward_on needs on `route` (0 or
// 1) at these widths: the streamed Hopper route's split w1 planes, else 0.
long long fno_head_scratch(int C, int hidden, int route) {
  if (route != 1 || !hopper_head_takes(C, hidden) || !hopper_head_streams(C, hidden)) return 0;
  return (long long)hopper_head_planes(C, hidden);
}

// x: (n, C) pixels; w1: (hidden, C); b1: (hidden,); w2: (n_out, hidden);
// b2: (n_out,); mask: (n,); out: (n, n_out). All float32, contiguous, on
// the current device; any positive widths. One launch per 8 outputs, on
// `route`: 0 the sm_80-style route at any widths, 1 the Hopper route where
// fno_head_route's bit 0 is set (x 16-byte aligned, n below 2^31 - 64;
// `planes`, fno_head_scratch floats, where its bit 1 is also set, else
// unused). products: 3 for split TF32, 1 for TF32 (tf32.cuh), else refused.
// Launches on `stream`, does not sync.
int fno_head_forward_on(const float* x, const float* w1, const float* b1, const float* w2,
                        const float* b2, const float* mask, float* out, float* planes,
                        long long n, int C, int hidden, int n_out, int products, int route,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || fno_head_unsupported(C, hidden, n_out) || route < 0 || route > 1) {
    return cudaErrorInvalidValue;
  }
  const bool streams = route == 1 && hopper_head_streams(C, hidden);
  if (route == 1 && (!hopper_head_takes(C, hidden) || n > 0x7fffffffLL - kHopTile ||
                     reinterpret_cast<uintptr_t>(x) % 16 || (streams && !planes))) {
    return cudaErrorInvalidValue;
  }
  if (streams) {
    const int total = (int)(hopper_head_planes(C, hidden) / 2);
    const int blocks = ceil_div(total, 256) < 1024 ? ceil_div(total, 256) : 1024;
    FNO_LAUNCH(fno_head_split_kernel, (unsigned)blocks, 256, 0, stream)(
        w1, planes, C, hidden, ceil_div(C, kHopKc), total);
    const cudaError_t err = cudaGetLastError();
    if (err) return err;
  }
  return with_products(products, [&](auto p) -> int {
    constexpr int P = decltype(p)::value;
    for (int o0 = 0; o0 < n_out; o0 += kMaxOut) {
      const int no = n_out - o0 < kMaxOut ? n_out - o0 : kMaxOut;
      const float* w2g = w2 + (size_t)o0 * hidden;
      int err;
      if (route == 1) {
        const auto hop = [&](auto outs, auto stream_w1) {
          return launch_head_hopper<decltype(outs)::value, P, decltype(stream_w1)::value>(
              x, w1, planes, b1, w2g, b2 + o0, mask, out + o0, (int)n, C, hidden, no, n_out,
              stream);
        };
        using Two = std::integral_constant<int, 2>;
        using Any = std::integral_constant<int, kMaxOut>;
        using Yes = std::true_type;
        using No = std::false_type;
        err = no == 2 ? (streams ? hop(Two{}, Yes{}) : hop(Two{}, No{}))
                      : (streams ? hop(Any{}, Yes{}) : hop(Any{}, No{}));
      } else {
        err = no == 2 ? launch_head<2, P>(x, w1, b1, w2g, b2 + o0, mask, out + o0, n, C, hidden,
                                          no, n_out, stream)
                      : launch_head<0, P>(x, w1, b1, w2g, b2 + o0, mask, out + o0, n, C, hidden,
                                          no, n_out, stream);
      }
      if (err) return err;
    }
    return cudaSuccess;
  });
}

// fno_head_forward_on without scratch, at every width it takes: on the
// Hopper route where fno_head_route takes it without scratch and x is
// 16-byte aligned, else on the sm_80 route.
int fno_head_forward(const float* x, const float* w1, const float* b1,
                     const float* w2, const float* b2, const float* mask,
                     float* out, long long n, int C, int hidden, int n_out,
                     int products, void* stream_ptr) {
  const int route = fno_head_route(C, hidden, n_out);
  const bool hopper = route == 1 && n <= 0x7fffffffLL - kHopTile &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return fno_head_forward_on(x, w1, b1, w2, b2, mask, out, nullptr, n, C, hidden, n_out, products,
                             hopper ? 1 : 0, stream_ptr);
}

}  // extern "C"
