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
// operations, 30 us, before the 67 M erff of GELU. The first version, one
// thread per pixel with 32-deep serial FMA chains, took 0.32 ms.
//
// Design: fc1 is a GEMM with M = B*H*W, K = C, N = hidden, run on the
// tensor cores as split TF32 (tf32.cuh), which holds float32 accuracy. A
// persistent block walks tiles of 128 pixels (16 KB of x at C = 32,
// contiguous), staged by cp.async one tile ahead of the products; each
// warp owns 16 pixels and computes their hidden units 64 at a time in
// registers. With one TF32 product per tile (template argument P = 1:
// --matmul_precision high) fc1 reads only the high halves; fc2 stays
// float32 FMA. Where w1 and two tiles of x fit shared memory (C up to 104 at
// 128 hidden units: the flagship), w1 is split once per block into
// fragment order there (fno_head_kernel). Wider, fc1 streams over the
// channels (fno_head_streamed_kernel): a unit of work is (tile, 64 hidden
// units, 64 channels), whose columns of x and rows of w1 come raw through
// a two-slot cp.async ring, w1 split as its fragments are read; the
// accumulators stay in registers across a tile's channel chunks, so shared
// memory (104 KB) no longer grows with C or the hidden width. erf-GELU,
// fc2 (float32 FMA against w2) and a shuffle reduction over the four lanes
// that share a pixel run on those registers, so the (B, H, W, 128)
// intermediate never leaves the SM. The mask multiplies at the end. A
// launch writes at most 8 outputs; the host launches one per group of 8,
// each recomputing fc1. The FNO's 2 outputs are a compile-time count; any
// other group is checked at run time.
// Measured at the flagship shape on an H100 80GB HBM3 at 700 W
// (scripts/bench_torch_kernels.py): 0.168 ms per call. The erf-GELU and
// fc2 epilogue issues most of the instructions (67 M erff per call); a
// branch-free erf fit (0.191 ms) and all 128 hidden units in one pass
// (0.181 ms) were slower.

#include "tf32.cuh"

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

}  // namespace

extern "C" {

// Null when fno_head_forward takes these widths, else why it does not.
const char* fno_head_unsupported(int C, int hidden, int n_out) {
  static thread_local char why[160];
  if (C >= 1 && hidden >= 1 && n_out >= 1) return nullptr;
  snprintf(why, sizeof why, "it takes positive widths and output counts, got C=%d, hidden=%d, "
           "outputs=%d", C, hidden, n_out);
  return why;
}

// x: (n, C) pixels; w1: (hidden, C); b1: (hidden,); w2: (n_out, hidden);
// b2: (n_out,); mask: (n,); out: (n, n_out). All float32, contiguous, on
// the current device; any positive widths. One launch per 8 outputs.
// products: 3 for split TF32, 1 for TF32 (tf32.cuh), else refused.
// Launches on `stream`, does not sync.
int fno_head_forward(const float* x, const float* w1, const float* b1,
                     const float* w2, const float* b2, const float* mask,
                     float* out, long long n, int C, int hidden, int n_out,
                     int products, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || fno_head_unsupported(C, hidden, n_out)) return cudaErrorInvalidValue;
  return with_products(products, [&](auto p) -> int {
    constexpr int P = decltype(p)::value;
    for (int o0 = 0; o0 < n_out; o0 += kMaxOut) {
      const int no = n_out - o0 < kMaxOut ? n_out - o0 : kMaxOut;
      const float* w2g = w2 + (size_t)o0 * hidden;
      const int err = no == 2 ? launch_head<2, P>(x, w1, b1, w2g, b2 + o0, mask, out + o0, n, C,
                                                  hidden, no, n_out, stream)
                              : launch_head<0, P>(x, w1, b1, w2g, b2 + o0, mask, out + o0, n, C,
                                                  hidden, no, n_out, stream);
      if (err) return err;
    }
    return cudaSuccess;
  });
}

}  // extern "C"
