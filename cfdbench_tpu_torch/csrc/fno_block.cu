// Fused FnoBlock forward for Hopper (sm_90a):
//   out = GELU(irfft2(mix(rfft2(x) on the retained modes)) + x @ w0^T + b0)
//
// Replaces: cfdbench_tpu/ops/pallas_fno.py::fused_fno_block (body
// `_kernel`), the TPU kernel that runs one whole FnoBlock per batch
// element with every intermediate in VMEM.
//
// What bounds it on this card: at the flagship shape (B=128, 64x64,
// 32->32 channels, 12x12 modes) it must read x (67 MB) and write the
// activation (67 MB): 41 us at 3.35 TB/s. Its 1.95 G multiply-adds in
// split TF32 (truncated DFTs both ways 1.41 G, 1x1 bypass 0.54 G), three
// TF32 products each at the card's 495 TFLOP/s, take 24 us, and the
// 0.15 G of per-mode complex mixing on the CUDA cores 5 us at 67
// TFLOP/s: the bound is the bytes, 41 us. The first version of this
// kernel ran every product as float32 FMAs on the CUDA cores and took
// 0.39 ms.
//
// Design: every stage but the mixing is a small real GEMM (K from 8 to
// 64), run on the tensor cores as split TF32 (tf32.cuh): three
// mma.sync.m16n8k8 products per tile hold float32 accuracy. The DFT tables
// are split and laid out in fragment order once on the host
// (ops/fno_kernels.py::_block_tables); x and the intermediates are split
// in registers. Every tensor-core pass also builds with one TF32 product
// per tile (template argument P = 1: --matmul_precision high), which reads
// only the high halves; the mixing stays float32 FMA in both modes.
// An image (512 KB at the flagship shape) does not fit one
// block's shared memory, so the retained modes (74 KB per image) and the
// inverse's row spectra go through device memory between four passes:
//   1. dft_forward_kernel: one block of 16 warps per (image, 32-channel
//      tile, mode chunk). It streams x eight rows by up to 64 columns
//      (64 KB) at a time through a two-slot cp.async ring (a wider grid
//      sums T over its column chunks), its 16-byte chunks XOR-swizzled
//      so that fragment loads hit distinct banks without padding: the
//      W-stage T = x_rows (256 x W) . E2 (W x 2 m2) is one 16-row tile
//      per warp; T goes to shared memory, and the H-stage xm += E1
//      (2K x 16) . T (16 x m2 C) accumulates every mode of the block in
//      registers across the row groups.
//   2. mode_mix_kernel: per retained mode a complex (images x Ci) @
//      (Ci x Co) product in 32 x 32 channel tiles, float32 FMA on the
//      CUDA cores, four images per thread: 7 % of the work. As a
//      split-TF32 GEMM per mode it was slower, held back by gathering
//      each mode's weights (strided by M1 M2 in device memory).
//   3. inverse_rows_kernel: the inverse H-stage, z = A (16 x 2K) . ym
//      (2K x m2 Co) per (image, 8-row tile), real and imaginary rows
//      together, into device memory (25 MB at the flagship shape, read
//      back from L2).
//   4. inverse_cols_kernel: per output row one GEMM folds the inverse
//      W-stage and the 1x1 bypass together,
//        out_h = [Br | -Bi | x_h] (W x (2 m2 + Ci)) . [z_r; z_i; w0^T],
//      with the bias and exact erf GELU applied to the accumulators, 32
//      output channels per grid row. Persistent, three blocks per SM: rows
//      of x and z come in by cp.async (16-byte copies of contiguous rows)
//      one item ahead of the products, the tables resident. Where the
//      tables and two whole rows of x and z do not fit a block (W x Ci or
//      W x m2 large: width 256 at W = 64, W = 512 at any width, 32 modes at
//      W = 256), inverse_cols_tiled_kernel runs the same GEMM on items of
//      two rows by 64 columns with its K in chunks of 64 through a two-slot
//      cp.async ring: the columns' [Br | -Bi] fragments with z's rows, then
//      the rows' x with w0 (raw, split as read), two blocks per SM.
// Passes 3 and 4 are separate kernels so that several blocks share an SM:
// fused into one persistent kernel the inverse was slower, its H-stage's
// loads exposed at one block per SM. Measured at the flagship shape on an
// H100 80GB HBM3 at 700 W (scripts/bench_torch_kernels.py): 0.208 ms per
// call, passes 0.050 / 0.031 / 0.036 / 0.091 ms, against 41 us of bytes.
// No pass reaches the tensor cores' or the memory's rate: the passes are
// bound by instruction issue and latency (staging, splits, erf), the cols
// pass most.
// Under spatial sharding a rank runs pass 1 on its rows, the ranks' partial
// spectra are summed, and it runs passes 2-4 for its rows: the host
// (ops/fno_kernels.py::_block_call) launches pass 1 (fno_block_spectrum) and
// passes 2-4 (fno_block_finish) apart, the sum between them. A rank's
// tables hold the DFT's columns (pass 1) and rows (pass 3) of its rows;
// both passes mask the rows past its count in their 8-row tiles.
// Shapes: every pass takes any positive size. Pass 1 streams x's columns
// 64 at a time above W = 64 and chunks the modes (12) and spectrum rows
// (24) over blocks; pass 2's staging is constant; pass 3 walks any K and
// m2 Co; pass 4 tiles as above. Offsets into x, the spectra and the output
// are 64-bit. fno_block_unsupported refuses only sizes that are not
// positive, and the host refuses those before launching.
// The mixed DC and Nyquist columns keep pocketfft's C2R semantics through
// the alpha-weighted B table (ops/spectral.py::_dft_factors). w0 is split
// per block (1K values) rather than cached on the host: it is the
// caller's tensor and may change between calls.

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Pass 1. These constants are mirrored in ops/fno_kernels.py.
constexpr int kFwdRows = 8;    // rows of x per group: the H-stage's K is 16 (real and imaginary T)
constexpr int kFwdChan = 32;   // channels per block: W-stage M = 8 x 32 = one 16-row tile per warp
constexpr int kFwdModes = 12;  // modes per block: W-stage N = 24 (3 tiles)
constexpr int kFwdK = 24;      // spectrum rows per block: H-stage M = 48 (3 tiles)
constexpr int kFwdMT = 3;
constexpr int kFwdNW = 3;
constexpr int kFwdWK = 8;  // W-stage k-steps per ring slot: x comes in 64 columns at a time
constexpr int kFwdThreads = 512;  // 16 warps, one per W-stage row tile
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdNTW = kFwdModes * kFwdChan / 8 / kFwdWarps;  // H-stage tiles per warp: 3
constexpr int kFwdSlots = 2;    // x ring: one group in flight while one is multiplied
constexpr int kFwdE1Slots = 3;  // E1 ring: a slot is refilled only after its H-stage
constexpr int kFwdE1 = kFwdMT * 2 * 64;  // float4 of E1 fragments per group (3 x 2 tiles)
// x is staged at 32 floats per (row, w), its 16-byte chunks XOR-swizzled
// by w % 4 so that a warp's A fragment loads hit 32 distinct banks; T
// rows (floats) = 8 mod 32 for the same reason.
constexpr int kTMode = kFwdChan + 4;
constexpr int kTRow = 456;
static_assert(kTRow >= kFwdModes * kTMode && kTRow % 32 == 8, "T row stride");

// Pass 2.
constexpr int kBatchTile = 32;  // images per block
constexpr int kMixImages = 4;   // images per thread
constexpr int kMixCo = 32;      // output channels per block
constexpr int kMixCi = 32;      // input channels per staged chunk
constexpr int kMixStride = kBatchTile + 2;  // float2 per input channel: fewer bank conflicts, float4-aligned

// Pass 3. kInvRows is mirrored in ops/fno_kernels.py.
constexpr int kInvRows = 8;  // rows per block: the H-stage's 16 rows are their real and imaginary parts
constexpr int kInvNT = 3;    // column tiles per warp per pass (6 or 2: slower)

// Pass 4.
constexpr int kOutRows = 2;  // output rows per item (4 or 8: slower)
constexpr int kOutNT = 4;    // output-channel tiles per warp task
constexpr int kOutCo = kOutNT * 8;  // output channels per grid row
constexpr int kOutSz = kOutCo + 8;  // z row stride, 8 mod 32: conflict-free B fragment loads
// Pass 4 tiled, where its tables and whole rows do not fit a block: an item
// is kOutRows rows by kOutCols columns, one 16-column tile per warp, and
// the K of [2 m2 | Ci] comes kOutKS k-steps at a time. A ring slot holds
// either a chunk of [Br | -Bi] (fragments) with the rows' z, or the rows'
// x with w0 (both raw, kOutXs floats a row: 4 mod 8, conflict-free).
constexpr int kOutCols = 64;
constexpr int kOutMT = kOutCols / 16;
constexpr int kOutKS = 8;
constexpr int kOutXs = kOutKS * 8 + 4;
constexpr int kOutZSlot = kOutMT * kOutKS * 64 * 4 + kOutRows * kOutKS * 8 * kOutSz;
constexpr int kOutXSlot = (kOutRows * kOutCols + kOutCo) * kOutXs;
constexpr int kOutSlot = kOutZSlot > kOutXSlot ? kOutZSlot : kOutXSlot;  // floats
static_assert(kOutRows * kOutMT == kWarps, "a warp an item's (row, 16-column tile)");

// Pass 1. xm (B, 2 re/im, K, m2, Ci): xm[b, :, k, m, c] = sum_h E1[k, h] sum_w E2[m, w] x[b, h, w, c].
// e1f: (n_kc, ceil(H/8), 3, 2, 32 lanes, 8) split A fragments of
//      [[E1r, -E1i], [E1i, E1r]] per group of 8 rows (columns: T's real
//      parts of the rows, then its imaginary parts).
// e2f: (n_mc, ceil(W/8), 3, 32 lanes, 4) split B fragments of [E2r^T | E2i^T].
// The ring's unit is (group of 8 rows, chunk of 64 columns). A grid up to
// 64 wide is one chunk per group and keeps its E2 fragments in shared
// memory (STREAM false: the chunk bookkeeping compiles away; kept at run
// time it slowed the pass from 0.050 to 0.061 ms at 64x64 on an H100 80GB
// HBM3). A wider grid (STREAM true) streams each chunk's E2 fragments
// with its columns of x and sums the chunks' T in shared memory.
__device__ __forceinline__ int x_swizzle(int w, int c) { return c ^ ((w & 3) << 3); }

template <bool STREAM, int P>
__global__ void __launch_bounds__(kFwdThreads, 1) dft_forward_kernel(
    const float* __restrict__ x, const float4* __restrict__ e1f, const float4* __restrict__ e2f,
    float* __restrict__ xm, int H, int W, int Ci, int K, int m2, int n_mc) {
  FNO_DYNAMIC_SMEM(float4, smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, c0 = blockIdx.y * kFwdChan, cn = min(kFwdChan, Ci - c0);
  const int kc = blockIdx.z / n_mc, mc = blockIdx.z % n_mc;
  const int k0 = kc * kFwdK, kn = min(kFwdK, K - k0);
  const int m0 = mc * kFwdModes, mn = min(kFwdModes, m2 - m0);
  const int n_groups = ceil_div(H, kFwdRows);
  const int wk = ceil_div(W, 8), n_wc = STREAM ? ceil_div(wk, kFwdWK) : 1;
  const int n_units = n_groups * n_wc;
  const int wck = min(wk, kFwdWK), wcp = wck * 8;  // k-steps and columns per chunk
  const int mt_n = ceil_div(2 * kn, 16), nw_n = ceil_div(2 * mn, 8), nh_n = mn * kFwdChan / 8;

  constexpr int e2_chunk = kFwdWK * kFwdNW * 32;                  // float4 per chunk's E2
  float4* e2s = smem4;  // resident: wk * 3 * 32; streamed: kFwdSlots x e2_chunk
  float4* e1s = e2s + (STREAM ? kFwdSlots * e2_chunk : wk * kFwdNW * 32);
  float* xs = reinterpret_cast<float*>(e1s + kFwdE1Slots * kFwdE1);  // kFwdSlots x [row][w][32]
  float* ts = xs + kFwdSlots * kFwdRows * wcp * kFwdChan;         // [re/im][row][kTRow]
  const int xbuf = kFwdRows * wcp * kFwdChan;

  const float4* e2b = e2f + (size_t)mc * wk * kFwdNW * 32;
  if (!STREAM) {
    for (int i = tid; i < wk * kFwdNW * 32; i += kFwdThreads) e2s[i] = e2b[i];
  }

  const float* xb = x + (size_t)b * H * W * Ci;
  const bool vec = Ci % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // Unit u: rows gi*8 .. gi*8+7 and columns wc*64 .. of the channel tile
  // (and a streamed chunk's E2 fragments) into ring slot u % 2, the
  // group's E1 fragments with its first chunk; zero outside x. Always
  // exactly one commit group.
  auto stage = [&](int u) {
    if (u < n_units) {
      const int gi = STREAM ? u / n_wc : u, wc = STREAM ? u % n_wc : 0, w0 = wc * kFwdWK * 8;
      float* dst = xs + (u % kFwdSlots) * xbuf;
      if (wc == 0) {
        const float4* e1g = e1f + ((size_t)kc * n_groups + gi) * kFwdE1;
        float4* e1d = e1s + (gi % kFwdE1Slots) * kFwdE1;
        for (int i = tid; i < kFwdE1; i += kFwdThreads) cp_async16(e1d + i, e1g + i);
      }
      if (STREAM) {
        const int n = min(kFwdWK, wk - wc * kFwdWK) * kFwdNW * 32;
        const float4* e2c = e2b + (size_t)wc * e2_chunk;
        float4* e2d = e2s + (u % kFwdSlots) * e2_chunk;
        for (int i = tid; i < n; i += kFwdThreads) cp_async16(e2d + i, e2c + i);
      }
      if (vec) {
        constexpr int q_n = kFwdChan / 4;
        Walk3 ix(tid, kFwdThreads, q_n, wcp);
        for (int i = tid; i < kFwdRows * wcp * q_n; i += kFwdThreads, ix.next()) {
          const int q = ix.i0, w = ix.i1, r = ix.i2, h = gi * kFwdRows + r;
          float* d = dst + (r * wcp + w) * kFwdChan + x_swizzle(w, 4 * q);
          if (h < H && w0 + w < W && 4 * q < cn) {
            cp_async16(d, xb + ((size_t)h * W + w0 + w) * Ci + c0 + 4 * q);
          } else {
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      } else {
        Walk3 ix(tid, kFwdThreads, kFwdChan, wcp);
        for (int i = tid; i < kFwdRows * wcp * kFwdChan; i += kFwdThreads, ix.next()) {
          const int c = ix.i0, w = ix.i1, r = ix.i2, h = gi * kFwdRows + r;
          float* d = dst + (r * wcp + w) * kFwdChan + x_swizzle(w, c);
          if (h < H && w0 + w < W && c < cn) {
            cp_async4(d, xb + ((size_t)h * W + w0 + w) * Ci + c0 + c);
          } else {
            *d = 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };

  float acc[kFwdMT][kFwdNTW][4];
#pragma unroll
  for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
    for (int j = 0; j < kFwdNTW; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

  // W-stage tile of this warp: row hh of the group, channels cb .. cb+15.
  const int hh = warp >> 1, cb = (warp & 1) * 16;
  stage(0);
  stage(1);
  for (int u = 0; u < n_units; ++u) {
    const int gi = STREAM ? u / n_wc : u, wc = STREAM ? u % n_wc : 0;
    cp_async_wait<1>();
    __syncthreads();  // unit u staged; the previous H-stage is done with T

    // W-stage: T[(row, c), n] = sum_w x[row, w, c] E2p[w, n], n = (re/im, mode),
    // over this chunk's columns; the small terms in their own accumulators,
    // for independent chains.
    float accw[kFwdNW][4], accl[kFwdNW][4];
#pragma unroll
    for (int nw = 0; nw < kFwdNW; ++nw)
#pragma unroll
      for (int i = 0; i < 4; ++i) accw[nw][i] = accl[nw][i] = 0.f;
    const float* xa = xs + (u % kFwdSlots) * xbuf + hh * wcp * kFwdChan;
    const float4* e2u = e2s + (STREAM ? (u % kFwdSlots) * e2_chunk : 0);
    const int ks_n = STREAM ? min(kFwdWK, wk - wc * kFwdWK) : wk;
    for (int ks = 0; ks < ks_n; ++ks) {
      // a0 (c = cb + g, w = 8 ks + t), a1 (c + 8), a2 (w + 4), a3 (c + 8, w + 4);
      // w % 4 = t for all four.
      const float* xw = xa + (ks * 8 + t) * kFwdChan;
      const int c = x_swizzle(t, cb + g), c8 = x_swizzle(t, cb + g + 8);
      uint32_t ahi[4], alo[4];
      split_tf32(xw[c], ahi[0], alo[0]);
      split_tf32(xw[c8], ahi[1], alo[1]);
      split_tf32(xw[4 * kFwdChan + c], ahi[2], alo[2]);
      split_tf32(xw[4 * kFwdChan + c8], ahi[3], alo[3]);
#pragma unroll
      for (int nw = 0; nw < kFwdNW; ++nw) {
        if (nw < nw_n) {
          uint32_t bhi[2], blo[2];
          load_b_frag(e2u + (ks * kFwdNW + nw) * 32 + lane, bhi, blo);
          if (P == 3) {
            mma_tf32(accl[nw], alo, bhi);
            mma_tf32(accl[nw], ahi, blo);
          }
          mma_tf32(accw[nw], ahi, bhi);
        }
      }
    }
#pragma unroll
    for (int nw = 0; nw < kFwdNW; ++nw) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nw * 8 + 2 * t + (i & 1), c = cb + g + (i >> 1) * 8;
        if (nw < nw_n && n < 2 * mn) {
          const int part = n >= mn ? 1 : 0, m = n - part * mn;
          float* d = ts + (part * kFwdRows + hh) * kTRow + m * kTMode + c;
          if (!STREAM || wc == 0) {
            *d = accw[nw][i] + accl[nw][i];
          } else {
            *d += accw[nw][i] + accl[nw][i];  // the same thread wrote *d
          }
        }
      }
    }
    __syncthreads();  // T written; every read of this x slot done
    stage(u + 2);
    if (STREAM && wc < n_wc - 1) continue;  // T needs the group's other chunks

    // H-stage: xm[(re/im, k), (m, c)] += sum_j E1p[., j] T[j, (m, c)]; k-step
    // ks of j takes T's real (ks = 0) or imaginary (ks = 1) parts of the
    // group's rows t and t + 4, split as they are read.
    const float4* e1g = e1s + (gi % kFwdE1Slots) * kFwdE1;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t bhi[kFwdNTW][2], blo[kFwdNTW][2];
#pragma unroll
      for (int j = 0; j < kFwdNTW; ++j) {
        const int n = (warp + kFwdWarps * j) * 8 + g, m = n / kFwdChan, c = n % kFwdChan;
        const float* tb = ts + (ks * kFwdRows + t) * kTRow + m * kTMode + c;
        if (warp + kFwdWarps * j < nh_n) {
          split_tf32(tb[0], bhi[j][0], blo[j][0]);
          split_tf32(tb[4 * kTRow], bhi[j][1], blo[j][1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kFwdMT; ++mt) {
        if (mt < mt_n) {
          uint32_t ehi[4], elo[4];
          load_a_frag(e1g + ((mt * 2 + ks) * 32 + lane) * 2, ehi, elo);
#pragma unroll
          for (int j = 0; j < kFwdNTW; ++j) {
            if (warp + kFwdWarps * j < nh_n) mma_tf32x<P>(acc[mt][j], ehi, elo, bhi[j], blo[j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* xmb = xm + (size_t)b * 2 * K * m2 * Ci;
#pragma unroll
  for (int mt = 0; mt < kFwdMT; ++mt) {
#pragma unroll
    for (int j = 0; j < kFwdNTW; ++j) {
      const int nt = warp + kFwdWarps * j;
      if (mt < mt_n && nt < nh_n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = mt * 16 + g + (i >> 1) * 8, n = nt * 8 + 2 * t + (i & 1);
          const int m = m0 + n / kFwdChan, c = c0 + n % kFwdChan;
          if (r < 2 * kn && c < Ci) {
            const int part = r >= kn ? 1 : 0, k = k0 + r - part * kn;
            xmb[(((size_t)part * K + k) * m2 + m) * Ci + c] = acc[mt][j][i];
          }
        }
      }
    }
  }
}

// Pass 2. ym[b, :, k, m, o] = sum_i xm[b, :, k, m, i] * Wc[corner, i, o, kk, m]
// (complex). Rows k < m1 are the first corner (frequencies 0..m1-1),
// rows k >= m1 the second (H-m1..H-1), as in spectral_conv2d_fft.
// weights: (2 corner, 2 re/im, Ci, Co, M1, M2), sliced to [:m1, :m2].
// One block per (mode, kBatchTile images, kMixCo output channels); a
// thread computes one output channel of kMixImages images, reading each
// weight once for all of them, over the input channels kMixCi at a time.
// Float32 FMA on the CUDA cores: as a split-TF32 GEMM per mode it was
// slower (0.037 against 0.030 ms at the flagship shape), held back by
// gathering the mode's weights, strided by M1 M2 in device memory.
__global__ void __launch_bounds__(kThreads) mode_mix_kernel(
    const float* __restrict__ xm, const float* __restrict__ weights,
    float* __restrict__ ym, int B, int K, int m1, int m2, int Ci, int Co,
    int M1, int M2) {
  static_assert(kThreads == kMixCo * kBatchTile / kMixImages, "a (channel, image quad) a thread");
  FNO_DYNAMIC_SMEM(float4, smem4);
  const int tid = threadIdx.x;
  const int km = blockIdx.x, k = km / m2, m = km % m2;
  const int corner = k >= m1 ? 1 : 0, kk = k - corner * m1;
  const int b0 = blockIdx.y * kBatchTile, bt = min(kBatchTile, B - b0);
  const int o0 = blockIdx.z * kMixCo;
  const size_t xplane = (size_t)K * m2 * Ci, yplane = (size_t)K * m2 * Co;
  float2* xs = reinterpret_cast<float2*>(smem4);  // [i][kMixStride], (re, im) per image
  float2* ws = xs + kMixCi * kMixStride;           // [i][o], (re, im)
  const size_t plane = (size_t)Ci * Co * M1 * M2;  // one (corner, re/im)
  const float* wc = weights + corner * 2 * plane + (size_t)kk * M2 + m;
  const int o = tid % kMixCo, ib = tid / kMixCo * kMixImages;
  float sr[kMixImages] = {}, si[kMixImages] = {};
  for (int c0 = 0; c0 < Ci; c0 += kMixCi) {
    const int cn = min(kMixCi, Ci - c0);
    __syncthreads();  // the previous chunk's reads done
    for (int i = tid; i < kMixCi * kMixCo; i += kThreads) {
      const int c = i / kMixCo, oc = o0 + i % kMixCo;
      const size_t w = ((size_t)(c0 + c) * Co + oc) * M1 * M2;
      ws[i] = c < cn && oc < Co ? make_float2(wc[w], wc[plane + w]) : make_float2(0.f, 0.f);
    }
    for (int i = tid; i < kBatchTile * kMixCi; i += kThreads) {
      const int c = i % kMixCi, bb = i / kMixCi;
      const size_t x = (size_t)(b0 + bb) * 2 * xplane + (size_t)km * Ci + c0 + c;
      xs[c * kMixStride + bb] =
          bb < bt && c < cn ? make_float2(xm[x], xm[x + xplane]) : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < cn; ++c) {
      const float2 w = ws[c * kMixCo + o];
      const float4* xv = reinterpret_cast<const float4*>(xs + c * kMixStride + ib);
#pragma unroll
      for (int q = 0; q < kMixImages / 2; ++q) {
        const float4 v = xv[q];  // images ib + 2q and ib + 2q + 1
        sr[2 * q] += v.x * w.x - v.y * w.y;
        si[2 * q] += v.x * w.y + v.y * w.x;
        sr[2 * q + 1] += v.z * w.x - v.w * w.y;
        si[2 * q + 1] += v.z * w.y + v.w * w.x;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kMixImages; ++q) {
    if (ib + q < bt && o0 + o < Co) {
      const size_t y = (size_t)(b0 + ib + q) * 2 * yplane + (size_t)km * Co + o0 + o;
      ym[y] = sr[q];
      ym[y + yplane] = si[q];
    }
  }
}

// Pass 3. z[b, h, :, o] = sum_k A[h, k] ym[b, :, k, m, o] (complex): rows
// 0..m2-1 of z are the real parts of the modes, m2..2m2-1 the imaginary
// parts. One block per (image, 8-row tile): M = 16 (the tile's real and
// imaginary rows), K = 2K, N = m2 Co. Small and register-light, so that
// many blocks share an SM and hide the latency of the ym loads.
// a1f: (ceil(H/8), ceil(2K/8), 32 lanes, 8) split A fragments of the
//      tile's rows of [[Ar, -Ai], [Ai, Ar]]: A rows g are the real part of
//      tile row g, rows g + 8 its imaginary part.
template <int P>
__global__ void __launch_bounds__(kThreads) inverse_rows_kernel(
    const float* __restrict__ ym, const float4* __restrict__ a1f, float* __restrict__ z, int H,
    int Co, int K, int m2) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, ht = blockIdx.y, h = ht * kInvRows + g;
  const int n1 = m2 * Co, nt1_n = ceil_div(n1, 8), k1_n = ceil_div(2 * K, 8);
  const float* yb = ym + (size_t)b * 2 * K * n1;
  const float4* a1t = a1f + (size_t)ht * k1_n * 64;
  for (int base = 0; base < nt1_n; base += kWarps * kInvNT) {
    float acc[kInvNT][4];
#pragma unroll
    for (int j = 0; j < kInvNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < k1_n; ++ks) {
      uint32_t ahi[4], alo[4];
      load_a_frag(a1t + (ks * 32 + lane) * 2, ahi, alo);
      const int kd0 = ks * 8 + t, kd1 = kd0 + 4;
      float v[kInvNT][2];
#pragma unroll
      for (int j = 0; j < kInvNT; ++j) {
        const int n = (base + warp + kWarps * j) * 8 + g;
        v[j][0] = n < n1 && kd0 < 2 * K ? __ldg(yb + (size_t)kd0 * n1 + n) : 0.f;
        v[j][1] = n < n1 && kd1 < 2 * K ? __ldg(yb + (size_t)kd1 * n1 + n) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kInvNT; ++j) {
        if (base + warp + kWarps * j < nt1_n) {
          uint32_t bhi[2], blo[2];
          split_tf32(v[j][0], bhi[0], blo[0]);
          split_tf32(v[j][1], bhi[1], blo[1]);
          mma_tf32x<P>(acc[j], ahi, alo, bhi, blo);
        }
      }
    }
    float* zh = z + ((size_t)b * H + h) * 2 * n1;
#pragma unroll
    for (int j = 0; j < kInvNT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = (base + warp + kWarps * j) * 8 + 2 * t + (i & 1);
        if (h < H && n < n1) zh[(i >> 1) * n1 + n] = acc[j][i];  // (re/im, m, o)
      }
    }
  }
}

// Pass 4's epilogue for one warp task: the bias and exact erf GELU on the
// accumulators of 16 columns (from w_base) by kOutCo channels (from o0) of
// one output row (offset `row`), into out and, unless null, pre.
__device__ __forceinline__ void cols_epilogue(const float (&acc)[kOutNT][4], const float* bs,
                                              float* __restrict__ out, float* __restrict__ pre,
                                              size_t row, int w_base, int W, int o0, int Co,
                                              int g, int t) {
  const bool pairs = Co % 2 == 0;
  // Channels o and o + 1 of one position (o + 1 only where it exists).
  auto put = [&](float* d, float v0, float v1, int o) {
    if (pairs) {
      *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
    } else {
      d[0] = v0;
      if (o + 1 < Co) d[1] = v1;
    }
  };
#pragma unroll
  for (int j = 0; j < kOutNT; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int w = w_base + g + 8 * half, ol = j * 8 + 2 * t, o = o0 + ol;
      if (w < W && o < Co) {
        const float p0 = acc[j][2 * half] + bs[ol], p1 = acc[j][2 * half + 1] + bs[ol + 1];
        const size_t at = row + (size_t)w * Co + o;
        put(out + at, gelu_erf(p0), gelu_erf(p1), o);
        if (pre) put(pre + at, p0, p1, o);
      }
    }
  }
}

// Pass 4. out[b, h, w, o] = GELU(sum_m Br[w, m] zr - Bi[w, m] zi + x[b, h, w, :] . w0[o, :] + b0[o]):
// per row one GEMM, [Br | -Bi | x_h] (W x (2 m2 + Ci)) . [z_r; z_i; w0^T],
// the inverse W-stage and the 1x1 bypass together, with the bias and exact
// erf GELU applied to the accumulators; `pre`, unless null, receives the
// pre-activation (the argument of GELU), which the block's backward reads. Each grid row takes kOutCo output
// channels. Persistent along the grid's columns: a block sets up its
// tables once and walks items of kOutRows rows, whose rows of x and z come
// in by cp.async (16-byte copies of contiguous rows) one item ahead of the
// products. A warp task is one row's 16 (w) x kOutCo (o) tile. Where the
// tables and two rows do not fit a block, inverse_cols_tiled_kernel runs.
// bwf: (ceil(W/16), KZ/8, 32 lanes, 8) split A fragments of [Br | -Bi],
//      KZ = 2 m2 rounded up to 8: a 16-column tile's are contiguous.
template <int P>
__global__ void __launch_bounds__(kThreads, 3) inverse_cols_kernel(
    const float* __restrict__ x, const float* __restrict__ z, const float4* __restrict__ bwf,
    const float* __restrict__ w0, const float* __restrict__ b0, float* __restrict__ out,
    float* __restrict__ pre, int B, int H, int W, int Ci, int Co, int m2) {
  FNO_DYNAMIC_SMEM(float4, smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.y * kOutCo, nto = ceil_div(min(kOutCo, Co - o0), 8);
  const int nh = ceil_div(H, kOutRows), n_items = B * nh;
  const int kz = round_up(2 * m2, 8), kx = round_up(Ci, 8);
  const int sx = kx + 4;  // conflict-free A fragment loads (and kOutSz for B)
  const int mtw_n = ceil_div(W, 16), wrows = mtw_n * 16;
  float4* bws = smem4;                                                 // mtw_n * kz/8 * 64
  float4* w0s = bws + mtw_n * (kz / 8) * 64;                           // kx/8 * kOutNT * 32
  float* bs = reinterpret_cast<float*>(w0s + (kx / 8) * kOutNT * 32);  // kOutCo
  float* bufs = bs + kOutCo;  // 2 x (rows x [kz][kOutSz] of z, then rows x [w][sx] of x)
  const int zrow = kz * kOutSz, xrow = wrows * sx, buf = kOutRows * (zrow + xrow);

  const bool xvec = Ci % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool zvec = Co % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  // The rows of x and z (this block's channels) of `item` into buffer
  // `slot`, zero outside them; always exactly one commit group.
  auto stage = [&](int item, int slot) {
    if (item < n_items) {
      const int b = item / nh, h0 = (item % nh) * kOutRows;
      const int rows = min(kOutRows, H - h0);
      float* zs = bufs + slot * buf;
      float* xs = zs + kOutRows * zrow;
      const float* xb = x + ((size_t)b * H + h0) * W * Ci;
      if (xvec) {
        const int q_n = kx / 4;
        Walk3 ix(tid, kThreads, q_n, wrows);
        for (int i = tid; i < rows * wrows * q_n; i += kThreads, ix.next()) {
          const int q = ix.i0, w = ix.i1, r = ix.i2;
          float* d = xs + r * xrow + w * sx + 4 * q;
          if (w < W && 4 * q < Ci) {
            cp_async16(d, xb + ((size_t)r * W + w) * Ci + 4 * q);
          } else {
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      } else {
        Walk3 ix(tid, kThreads, kx, wrows);
        for (int i = tid; i < rows * wrows * kx; i += kThreads, ix.next()) {
          const int c = ix.i0, w = ix.i1, r = ix.i2;
          float* d = xs + r * xrow + w * sx + c;
          if (w < W && c < Ci) {
            cp_async4(d, xb + ((size_t)r * W + w) * Ci + c);
          } else {
            *d = 0.f;
          }
        }
      }
      const float* zb = z + ((size_t)b * H + h0) * 2 * m2 * Co + o0;
      if (zvec) {
        constexpr int q_n = kOutCo / 4;
        Walk3 ix(tid, kThreads, q_n, kz);
        for (int i = tid; i < rows * kz * q_n; i += kThreads, ix.next()) {
          const int q = ix.i0, kd = ix.i1, r = ix.i2;
          float* d = zs + r * zrow + kd * kOutSz + 4 * q;
          if (kd < 2 * m2 && o0 + 4 * q < Co) {
            cp_async16(d, zb + ((size_t)r * 2 * m2 + kd) * Co + 4 * q);
          } else {
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      } else {
        Walk3 ix(tid, kThreads, kOutCo, kz);
        for (int i = tid; i < rows * kz * kOutCo; i += kThreads, ix.next()) {
          const int o = ix.i0, kd = ix.i1, r = ix.i2;
          float* d = zs + r * zrow + kd * kOutSz + o;
          if (kd < 2 * m2 && o0 + o < Co) {
            cp_async4(d, zb + ((size_t)r * 2 * m2 + kd) * Co + o);
          } else {
            *d = 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };

  int item = blockIdx.x;
  stage(item, 0);  // the first item's rows come in under the table set-up
  for (int i = tid; i < mtw_n * (kz / 8) * 64; i += kThreads) bws[i] = bwf[i];
  // This block's columns of w0^T as split B fragments: element (i, o) = w0[o0 + o, i].
  for (int i = tid; i < (kx / 8) * kOutNT * 32; i += kThreads) {
    const int l = i % 32, nt = (i / 32) % kOutNT, ks = i / (32 * kOutNT);
    const int o = o0 + nt * 8 + (l >> 2), c = ks * 8 + (l & 3);
    const float v0 = o < Co && c < Ci ? w0[(size_t)o * Ci + c] : 0.f;
    const float v1 = o < Co && c + 4 < Ci ? w0[(size_t)o * Ci + c + 4] : 0.f;
    uint32_t hi0, lo0, hi1, lo1;
    split_tf32(v0, hi0, lo0);
    split_tf32(v1, hi1, lo1);
    w0s[i] = make_float4(__uint_as_float(hi0), __uint_as_float(hi1), __uint_as_float(lo0),
                         __uint_as_float(lo1));
  }
  for (int i = tid; i < kOutCo; i += kThreads) bs[i] = o0 + i < Co ? b0[o0 + i] : 0.f;

  const int tasks = kOutRows * mtw_n;
  for (int it = 0; item < n_items; ++it, item += gridDim.x) {
    stage(item + gridDim.x, (it + 1) & 1);
    cp_async_wait<1>();
    __syncthreads();  // this item's rows staged (and, the first time, the tables)
    const int b = item / nh, h0 = (item % nh) * kOutRows;
    const int rows = min(kOutRows, H - h0);
    const float* zs = bufs + (it & 1) * buf;
    const float* xs = zs + kOutRows * zrow;
    for (int task = warp; task < tasks; task += kWarps) {
      const int r = task % kOutRows, mtw = task / kOutRows;
      if (r >= rows) continue;
      float acc[kOutNT][4];
#pragma unroll
      for (int j = 0; j < kOutNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      for (int ks = 0; ks < kz / 8; ++ks) {
        uint32_t ahi[4], alo[4];
        load_a_frag(bws + ((mtw * (kz / 8) + ks) * 32 + lane) * 2, ahi, alo);
        const float* zk = zs + r * zrow + (ks * 8 + t) * kOutSz + g;
#pragma unroll
        for (int j = 0; j < kOutNT; ++j) {
          if (j < nto) {
            uint32_t bhi[2], blo[2];
            split_tf32(zk[j * 8], bhi[0], blo[0]);
            split_tf32(zk[j * 8 + 4 * kOutSz], bhi[1], blo[1]);
            mma_tf32x<P>(acc[j], ahi, alo, bhi, blo);
          }
        }
      }
      for (int ks = 0; ks < kx / 8; ++ks) {
        uint32_t ahi[4], alo[4];
        load_a_split(xs + r * xrow + mtw * 16 * sx + ks * 8, sx, 1, g, t, ahi, alo);
#pragma unroll
        for (int j = 0; j < kOutNT; ++j) {
          if (j < nto) {
            uint32_t bhi[2], blo[2];
            load_b_frag(w0s + (ks * kOutNT + j) * 32 + lane, bhi, blo);
            mma_tf32x<P>(acc[j], ahi, alo, bhi, blo);
          }
        }
      }
      cols_epilogue(acc, bs, out, pre, ((size_t)b * H + h0 + r) * W * Co, mtw * 16, W, o0, Co,
                    g, t);
    }
    __syncthreads();  // every read of this buffer done before it is refilled
  }
  cp_async_wait<0>();
}

// Pass 4 at any shape: the same GEMM per item of kOutRows rows by kOutCols
// columns, its K [2 m2 | Ci] in chunks of kOutKS k-steps through a two-slot
// cp.async ring, so that neither a whole row of x nor the whole [Br | -Bi]
// table is resident. A unit of the ring is (item, chunk): the first
// ceil(KZ / 8 kOutKS) chunks stage the item's 16-column tiles' fragments of
// [Br | -Bi] (rows of bwf, as the resident kernel reads them) and the
// chunk's rows of z; the rest stage the chunk's channels of the rows' x and
// of w0 raw, split as they are read. Warp w owns row w % kOutRows and
// 16-column tile w / kOutRows of the item; its accumulators stay in
// registers across the item's chunks.
template <int P>
__global__ void __launch_bounds__(kThreads, 2) inverse_cols_tiled_kernel(
    const float* __restrict__ x, const float* __restrict__ z, const float4* __restrict__ bwf,
    const float* __restrict__ w0, const float* __restrict__ b0, float* __restrict__ out,
    float* __restrict__ pre, int B, int H, int W, int Ci, int Co, int m2) {
  FNO_DYNAMIC_SMEM(float4, smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.y * kOutCo, nto = ceil_div(min(kOutCo, Co - o0), 8);
  const int nh = ceil_div(H, kOutRows), n_ct = ceil_div(W, kOutCols), mtw_n = ceil_div(W, 16);
  const int kzs = round_up(2 * m2, 8) / 8, kxs = ceil_div(Ci, 8);
  const int n_zc = ceil_div(kzs, kOutKS), n_chunks = n_zc + ceil_div(kxs, kOutKS);
  const long long n_items = (long long)B * nh * n_ct;
  const long long my_items =
      blockIdx.x < n_items ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long n_units = my_items * n_chunks;
  float* bs = reinterpret_cast<float*>(smem4);  // kOutCo
  float* slots = bs + kOutCo;                   // 2 x kOutSlot
  for (int i = tid; i < kOutCo; i += kThreads) bs[i] = o0 + i < Co ? b0[o0 + i] : 0.f;

  const bool xvec = Ci % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w0) % 16 == 0;
  const bool zvec = Co % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  // Item i of this block: (image b, row pair hp, column tile ct).
  struct Item {
    int b, h0, rows, ct;
  };
  auto item_of = [&](long long u) {
    const long long item = blockIdx.x + u / n_chunks * gridDim.x;
    Item it;
    it.ct = (int)(item % n_ct);
    const long long bh = item / n_ct;
    it.b = (int)(bh / nh);
    it.h0 = (int)(bh % nh) * kOutRows;
    it.rows = min(kOutRows, H - it.h0);
    return it;
  };
  // Unit u into slot u % 2, zero where a read one falls outside x, z or w0;
  // always exactly one commit group.
  auto stage = [&](long long u) {
    if (u < n_units) {
      const Item it = item_of(u);
      const int ch = (int)(u % n_chunks);
      float* s = slots + (u & 1) * kOutSlot;
      if (ch < n_zc) {
        const int ks0 = ch * kOutKS, ks_n = min(kOutKS, kzs - ks0);
        float4* bwd = reinterpret_cast<float4*>(s);  // [mt][ks][64]
        for (int i = tid; i < kOutMT * kOutKS * 64; i += kThreads) {
          const int l = i % 64, ks = i / 64 % kOutKS, mt = i / (64 * kOutKS);
          const int mtw = it.ct * kOutMT + mt;
          if (mtw < mtw_n && ks < ks_n)
            cp_async16(bwd + i, bwf + ((size_t)mtw * kzs + ks0 + ks) * 64 + l);
        }
        float* zs = s + kOutMT * kOutKS * 64 * 4;  // [r][kd][kOutSz]
        const float* zb = z + ((size_t)it.b * H + it.h0) * 2 * m2 * Co + o0;
        const int kd_n = ks_n * 8, kd0 = ks0 * 8;
        if (zvec) {
          constexpr int q_n = kOutCo / 4;
          Walk3 ix(tid, kThreads, q_n, kd_n);
          for (int i = tid; i < it.rows * kd_n * q_n; i += kThreads, ix.next()) {
            const int q = ix.i0, kd = ix.i1, r = ix.i2;
            float* d = zs + (r * kOutKS * 8 + kd) * kOutSz + 4 * q;
            if (kd0 + kd < 2 * m2 && o0 + 4 * q < Co) {
              cp_async16(d, zb + ((size_t)r * 2 * m2 + kd0 + kd) * Co + 4 * q);
            } else {
              *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
        } else {
          Walk3 ix(tid, kThreads, kOutCo, kd_n);
          for (int i = tid; i < it.rows * kd_n * kOutCo; i += kThreads, ix.next()) {
            const int o = ix.i0, kd = ix.i1, r = ix.i2;
            float* d = zs + (r * kOutKS * 8 + kd) * kOutSz + o;
            if (kd0 + kd < 2 * m2 && o0 + o < Co) {
              cp_async4(d, zb + ((size_t)r * 2 * m2 + kd0 + kd) * Co + o);
            } else {
              *d = 0.f;
            }
          }
        }
      } else {
        // kOutRows x kOutCols rows of x, then kOutCo rows of w0: [row][kOutXs].
        const int c0 = (ch - n_zc) * kOutKS * 8, w0c = it.ct * kOutCols;
        const int n_rows = kOutRows * kOutCols + kOutCo;
        const float* xb = x + ((size_t)it.b * H + it.h0) * W * Ci;
        // Source of staged row rr at channel c, or null where it is zero.
        auto src = [&](int rr, int c) -> const float* {
          if (c >= Ci) return nullptr;
          if (rr >= kOutRows * kOutCols) {
            const int o = o0 + rr - kOutRows * kOutCols;
            return o < Co ? w0 + (size_t)o * Ci + c : nullptr;
          }
          const int r = rr / kOutCols, w = w0c + rr % kOutCols;
          return r < it.rows && w < W ? xb + ((size_t)r * W + w) * Ci + c : nullptr;
        };
        if (xvec) {
          constexpr int q_n = kOutKS * 2;
          Walk3 ix(tid, kThreads, q_n, n_rows);
          for (int i = tid; i < n_rows * q_n; i += kThreads, ix.next()) {
            float* d = s + ix.i1 * kOutXs + 4 * ix.i0;
            const float* p = src(ix.i1, c0 + 4 * ix.i0);
            if (p) {
              cp_async16(d, p);
            } else {
              *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
        } else {
          constexpr int c_n = kOutKS * 8;
          Walk3 ix(tid, kThreads, c_n, n_rows);
          for (int i = tid; i < n_rows * c_n; i += kThreads, ix.next()) {
            float* d = s + ix.i1 * kOutXs + ix.i0;
            const float* p = src(ix.i1, c0 + ix.i0);
            if (p) {
              cp_async4(d, p);
            } else {
              *d = 0.f;
            }
          }
        }
      }
    }
    cp_async_commit();
  };

  const int r = warp % kOutRows, mt = warp / kOutRows;
  float acc[kOutNT][4];
  stage(0);
  stage(1);
  for (long long u = 0; u < n_units; ++u) {
    const Item it = item_of(u);
    const int ch = (int)(u % n_chunks);
    cp_async_wait<1>();
    __syncthreads();  // unit u staged (and, the first time, the bias)
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < kOutNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
    const float* s = slots + (u & 1) * kOutSlot;
    if (r < it.rows && it.ct * kOutMT + mt < mtw_n) {
      if (ch < n_zc) {
        const int ks_n = min(kOutKS, kzs - ch * kOutKS);
        const float4* bwd = reinterpret_cast<const float4*>(s) + mt * kOutKS * 64;
        const float* zs = s + kOutMT * kOutKS * 64 * 4 + r * kOutKS * 8 * kOutSz;
        for (int ks = 0; ks < ks_n; ++ks) {
          uint32_t ahi[4], alo[4];
          load_a_frag(bwd + ks * 64 + 2 * lane, ahi, alo);
          const float* zk = zs + (ks * 8 + t) * kOutSz + g;
#pragma unroll
          for (int j = 0; j < kOutNT; ++j) {
            if (j < nto) {
              uint32_t bhi[2], blo[2];
              split_tf32(zk[j * 8], bhi[0], blo[0]);
              split_tf32(zk[j * 8 + 4 * kOutSz], bhi[1], blo[1]);
              mma_tf32x<P>(acc[j], ahi, alo, bhi, blo);
            }
          }
        }
      } else {
        const int ks_n = min(kOutKS, kxs - (ch - n_zc) * kOutKS);
        const float* xa = s + (r * kOutCols + mt * 16) * kOutXs;
        const float* wb = s + kOutRows * kOutCols * kOutXs;
        for (int ks = 0; ks < ks_n; ++ks) {
          uint32_t ahi[4], alo[4];
          load_a_split(xa + ks * 8, kOutXs, 1, g, t, ahi, alo);
#pragma unroll
          for (int j = 0; j < kOutNT; ++j) {
            if (j < nto) {
              // b0 (k = t, n = g) is w0[o0 + 8 j + g, c0 + 8 ks + t]; b1 four channels on.
              const float* wv = wb + (j * 8 + g) * kOutXs + ks * 8 + t;
              uint32_t bhi[2], blo[2];
              split_tf32(wv[0], bhi[0], blo[0]);
              split_tf32(wv[4], bhi[1], blo[1]);
              mma_tf32x<P>(acc[j], ahi, alo, bhi, blo);
            }
          }
        }
      }
      if (ch == n_chunks - 1) {
        cols_epilogue(acc, bs, out, pre, ((size_t)it.b * H + it.h0 + r) * W * Co,
                      it.ct * kOutCols + mt * 16, W, o0, Co, g, t);
      }
    }
    __syncthreads();  // every read of this slot done before it is refilled
    stage(u + 2);
  }
  cp_async_wait<0>();
}

// Shared memory of each pass at one shape, and whether pass 4 runs tiled;
// `why` names a size that is not positive, or is null.
struct BlockPlan {
  size_t s1, s2, s4;
  bool tiled;
  const char* why;
};

BlockPlan plan_block(int W, int Ci, int m2) {
  static thread_local char why[160];
  BlockPlan p{};
  if (W < 1 || Ci < 1 || m2 < 1) {
    snprintf(why, sizeof why, "it takes positive sizes, got W=%d, Ci=%d, %d modes along W", W,
             Ci, m2);
    p.why = why;
    return p;
  }
  const size_t wk = ceil_div(W, 8), wck = wk < kFwdWK ? wk : kFwdWK;
  const size_t e2 = (wk <= kFwdWK ? wk : kFwdSlots * kFwdWK) * kFwdNW * 32;  // resident or streamed
  p.s1 = 16 * (e2 + kFwdE1Slots * kFwdE1) +
         sizeof(float) * (kFwdSlots * kFwdRows * wck * 8 * kFwdChan + 2 * kFwdRows * kTRow);
  p.s2 = sizeof(float2) * kMixCi * (kMixStride + kMixCo);
  const size_t kz = round_up(2 * m2, 8), kx = round_up(Ci, 8), mtw_n = ceil_div(W, 16);
  p.s4 = 16 * (mtw_n * (kz / 8) * 64 + (kx / 8) * kOutNT * 32) +
         sizeof(float) * (kOutCo + 2 * kOutRows * (kz * kOutSz + mtw_n * 16 * (kx + 4)));
  p.tiled = p.s4 > kMaxDynamicSmem;
  if (p.tiled) p.s4 = sizeof(float) * (kOutCo + 2 * kOutSlot);
  return p;
}

// Passes 2-4 in P TF32 products (fno_block_finish).
template <int P>
int block_finish(const float* x, const float* xm, const float* weights, const float* w0,
                 const float* b0, const float* a1f, const float* bwf, float* ym, float* z,
                 float* out, float* pre, int B, int H, int W, int Ci, int Co, int M1, int M2,
                 int m1, int m2, const BlockPlan& plan, cudaStream_t stream) {
  const int K = 2 * m1;
  const int nh = ceil_div(H, kOutRows), n_ot = ceil_div(Co, kOutCo);
  const long long n_items = (long long)B * nh * (plan.tiled ? ceil_div(W, kOutCols) : 1);
  const auto cols = plan.tiled ? inverse_cols_tiled_kernel<P> : inverse_cols_kernel<P>;
  cudaError_t err;
  if ((err = allow_dynamic_smem((const void*)mode_mix_kernel, plan.s2))) return err;
  if ((err = allow_dynamic_smem((const void*)cols, plan.s4))) return err;
  int cols_blocks = 0;  // all output-channel tiles together
  if ((err = persistent_blocks(cols, kThreads, plan.s4, n_items * n_ot, &cols_blocks))) return err;
  FNO_LAUNCH(mode_mix_kernel, dim3(K * m2, ceil_div(B, kBatchTile), ceil_div(Co, kMixCo)),
             kThreads, plan.s2, stream)(xm, weights, ym, B, K, m1, m2, Ci, Co, M1, M2);
  if ((err = cudaGetLastError())) return err;
  FNO_LAUNCH(inverse_rows_kernel<P>, dim3(B, ceil_div(H, kInvRows)), kThreads, 0, stream)(
      ym, reinterpret_cast<const float4*>(a1f), z, H, Co, K, m2);
  if ((err = cudaGetLastError())) return err;
  const dim3 cols_grid(cols_blocks > n_ot ? cols_blocks / n_ot : 1, n_ot);
  FNO_LAUNCH(cols, cols_grid, kThreads, plan.s4, stream)(
      x, z, reinterpret_cast<const float4*>(bwf), w0, b0, out, pre, B, H, W, Ci, Co, m2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fno_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The tiles of the forward and inverse-rows passes that
// ops/fno_kernels.py::_block_tables lays the DFT tables out for:
// kFwdRows, kFwdModes, kFwdK, kFwdMT, kFwdNW, kInvRows.
void fno_block_tiles(int* tiles) {
  const int t[] = {kFwdRows, kFwdModes, kFwdK, kFwdMT, kFwdNW, kInvRows};
  for (int i = 0; i < 6; ++i) tiles[i] = t[i];
}

// Null when fno_block_spectrum and fno_block_finish take a grid W wide
// with Ci input channels and m2 retained modes along W (every positive
// size), else why they do not.
const char* fno_block_unsupported(int W, int Ci, int m2) { return plan_block(W, Ci, m2).why; }

// The block runs in two calls around its retained spectrum, so that under
// spatial sharding (a rank holding rows r0 .. r0+H-1 of a taller grid) the
// ranks' partial spectra can be summed between them: pass 1 is a sum over
// rows. Without a split the host calls one after the other.
//
// fno_block_spectrum, pass 1: xm (B, 2, 2*m1, m2, Ci) = x's retained modes,
// rows 0..m1-1 and H-m1..H-1 of rfft2 (of the global grid's rows), real
// then imaginary parts, summed over the H rows of x (B, H, W, Ci) that
// this call holds. e1f, e2f: ops/fno_kernels.py::_block_tables for those
// rows. products: 3 for split TF32, 1 for TF32 (tf32.cuh), else refused.
int fno_block_spectrum(const float* x, const float* e1f, const float* e2f, float* xm, int B,
                       int H, int W, int Ci, int m1, int m2, int products, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const BlockPlan plan = plan_block(W, Ci, m2);
  if (plan.why) return cudaErrorInvalidValue;
  const int K = 2 * m1, n_kc = ceil_div(K, kFwdK), n_mc = ceil_div(m2, kFwdModes);
  const bool stream_w = ceil_div(W, 8) > kFwdWK;
  const dim3 forward_grid(B, ceil_div(Ci, kFwdChan), n_kc * n_mc);
  const float4* e1q = reinterpret_cast<const float4*>(e1f);
  const float4* e2q = reinterpret_cast<const float4*>(e2f);
  return with_products(products, [&](auto p) -> int {
    constexpr int P = decltype(p)::value;
    const auto forward = stream_w ? dft_forward_kernel<true, P> : dft_forward_kernel<false, P>;
    cudaError_t err;
    if ((err = allow_dynamic_smem((const void*)forward, plan.s1))) return err;
    FNO_LAUNCH(forward, forward_grid, kFwdThreads, plan.s1, stream)(x, e1q, e2q, xm, H, W, Ci, K,
                                                                     m2, n_mc);
    return cudaGetLastError();
  });
}

// fno_block_finish, passes 2-4 on the whole retained spectrum xm, for the H
// rows of x (B, H, W, Ci) that this call holds: weights (2, 2, Ci, Co, M1,
// M2); w0 (Co, Ci); b0 (Co,); a1f, bwf: ops/fno_kernels.py::_block_tables
// for those rows; scratch ym (B, 2, 2*m1, m2, Co) and z (B, H, 2, m2, Co);
// out and, unless null, pre (the pre-activation): (B, H, W, Co). All
// float32, contiguous, on the current device; products as for
// fno_block_spectrum. Launches on `stream`, does not sync.
int fno_block_finish(const float* x, const float* xm, const float* weights, const float* w0,
                     const float* b0, const float* a1f, const float* bwf, float* ym, float* z,
                     float* out, float* pre, int B, int H, int W, int Ci, int Co, int M1, int M2,
                     int m1, int m2, int products, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const BlockPlan plan = plan_block(W, Ci, m2);
  if (plan.why) return cudaErrorInvalidValue;
  return with_products(products, [&](auto p) -> int {
    constexpr int P = decltype(p)::value;
    return block_finish<P>(x, xm, weights, w0, b0, a1f, bwf, ym, z, out, pre, B, H, W, Ci, Co,
                           M1, M2, m1, m2, plan, stream);
  });
}

}  // extern "C"
