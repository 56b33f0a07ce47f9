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
// registers. w1 is split once per block into fragment order in shared
// memory; where w1 and two tiles of x do not fit (C above 104 at 128
// hidden units), x is single-buffered, up to C = 144. erf-GELU, fc2
// (float32 FMA against w2 in shared memory) and a shuffle reduction over
// the four lanes that share a pixel run on those registers, so the
// (B, H, W, 128) intermediate never leaves the SM. The
// mask multiplies at the end. The FNO's 2 outputs are a compile-time
// count; any other count up to 8 is checked at run time.
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
constexpr int kMaxOut = 8;

// NOUT: the output count when it is fixed at compile time (the FNO's 2),
// or 0 for any count up to kMaxOut, checked at run time.
template <int NOUT>
__global__ void __launch_bounds__(kHeadThreads) fno_head_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ mask,
    float* __restrict__ out, long long n, int C, int hidden, int n_out, int slots) {
  constexpr int OUTS = NOUT ? NOUT : kMaxOut;
  FNO_DYNAMIC_SMEM(float4, smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kc = ceil_div(C, 8), kp = kc * 8, sx = kp + 4;  // sx = 4 mod 8: conflict-free A loads
  const int nth = ceil_div(hidden, 8), hp = nth * 8;
  float4* w1s = smem4;                                             // kc * nth * 32
  float* b1s = reinterpret_cast<float*>(w1s + kc * nth * 32);      // hp
  float* w2s = b1s + hp;                                           // n_out * hp
  float* b2s = w2s + n_out * hp;                                   // kMaxOut
  float* xs = b2s + kMaxOut;                                       // slots x [pixel][sx]

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
    if (slots == 2 && next < n_tiles) {
      stage(next, xs + ((it + 1) & 1) * kTile * sx);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile staged (and, the first time, the weights)
    const float* xa = xs + (slots == 2 ? it & 1 : 0) * kTile * sx + warp * 16 * sx;
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
            mma_3xtf32(acc[j], ahi, alo, bhi, blo);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (nc + j < nth) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = (nc + j) * 8 + 2 * t + (i & 1);
            const float hdn = gelu_erf(acc[j][i] + b1s[col]);
#pragma unroll
            for (int o = 0; o < OUTS; ++o) {
              if (NOUT || o < n_out) s[o][i >> 1] = fmaf(hdn, w2s[o * hp + col], s[o][i >> 1]);
            }
          }
        }
      }
    }
    // The four lanes of a group hold disjoint hidden units of the same pixels.
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[o][r] += __shfl_xor_sync(0xffffffffu, s[o][r], 1);
        s[o][r] += __shfl_xor_sync(0xffffffffu, s[o][r], 2);
      }
    }
    if (t < 2) {
      const long long p = tile * kTile + warp * 16 + g + 8 * t;
      if (p < n) {
        const float mk = mask[p];
#pragma unroll
        for (int o = 0; o < OUTS; ++o) {
          if (NOUT || o < n_out) out[p * n_out + o] = ((t ? s[o][1] : s[o][0]) + b2s[o]) * mk;
        }
      }
    }
    __syncthreads();  // every read of this x buffer done before it is refilled
    if (slots == 1 && next < n_tiles) stage(next, xs);
  }
}

// Shared memory of the head kernel with `slots` tiles of x.
size_t head_smem(int C, int hidden, int n_out, int slots) {
  const size_t kc = ceil_div(C, 8), nth = ceil_div(hidden, 8), hp = nth * 8;
  return 16 * kc * nth * 32 +
         sizeof(float) * (hp + n_out * hp + kMaxOut + slots * kTile * (kc * 8 + 4));
}

template <int NOUT>
int launch_head(const float* x, const float* w1, const float* b1,
                const float* w2, const float* b2, const float* mask,
                float* out, long long n, int C, int hidden, int n_out,
                cudaStream_t stream) {
  // x double-buffered where two tiles fit, else one tile staged after the last.
  const int slots = head_smem(C, hidden, n_out, 2) <= kMaxDynamicSmem ? 2 : 1;
  const size_t smem = head_smem(C, hidden, n_out, slots);
  const void* kernel = (const void*)fno_head_kernel<NOUT>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err) return err;
  int blocks = 0;
  if ((err = persistent_blocks(fno_head_kernel<NOUT>, kHeadThreads, smem, (n + kTile - 1) / kTile,
                               &blocks)))
    return err;
  FNO_LAUNCH(fno_head_kernel<NOUT>, (unsigned)blocks, kHeadThreads, smem, stream)(
      x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out, slots);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Null when fno_head_forward takes these widths, else why it does not.
const char* fno_head_unsupported(int C, int hidden, int n_out) {
  static thread_local char why[256];
  if (C < 1 || hidden < 1 || n_out < 1 || n_out > kMaxOut) {
    snprintf(why, sizeof why, "it takes 1 to %d outputs and positive widths, got C=%d, "
             "hidden=%d, outputs=%d", kMaxOut, C, hidden, n_out);
    return why;
  }
  const size_t smem = head_smem(C, hidden, n_out, 1);
  if (smem <= kMaxDynamicSmem) return nullptr;
  snprintf(why, sizeof why, "fc1's split weights (%d x %d) and a tile of %d pixels of x need "
           "%zu bytes of shared memory a block, above the card's %zu",
           hidden, C, kTile, smem, kMaxDynamicSmem);
  return why;
}

// x: (n, C) pixels; w1: (hidden, C); b1: (hidden,); w2: (n_out, hidden);
// b2: (n_out,); mask: (n,); out: (n, n_out). All float32, contiguous, on
// the current device; widths that fno_head_unsupported accepts (C up to
// 144 at 128 hidden units). Launches on `stream`, does not sync.
int fno_head_forward(const float* x, const float* w1, const float* b1,
                     const float* w2, const float* b2, const float* mask,
                     float* out, long long n, int C, int hidden, int n_out,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || fno_head_unsupported(C, hidden, n_out)) return cudaErrorInvalidValue;
  if (n_out == 2)
    return launch_head<2>(x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out, stream);
  return launch_head<0>(x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out, stream);
}

}  // extern "C"
