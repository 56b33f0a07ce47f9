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
// TF32 products each at the card's 495 TFLOP/s, take 24 us: the bound is
// the bytes. A design in passes reads x twice (the forward DFT and the
// bypass, which need every image's spectrum between them): 201 MB, 60 us.
//
// Two routes, chosen by the shape before a launch (fno_block_route), never
// after a failure:
//
// The Hopper route, where the channel counts are multiples of 4 (TMA's
// 16-byte strides) and the tables fit a block; pass 1 on it at most 12
// modes each way. Every product is wgmma (hopper.cuh) in split TF32, three
// products a k-step into one accumulator (P = 1, --matmul_precision high:
// one), A the data from registers, split there, B the constants in
// shared memory, split on the host (the DFT tables) or once a block (w0).
//   1. dft_forward_hopper_kernel, per (image, 16 channels): a producer warp
//      keeps TMA boxes of x (4 rows x 64 columns x 16 channels, 64-byte
//      swizzle) in flight through a four-slot mbarrier ring; the
//      warpgroup's W-stage (M 64 = 4 rows x 16 channels, N 24, K 64 a box)
//      goes through shared memory to the H-stage (M 3 x 64 = (mode,
//      channel), N 48 = (re/im, k), K 16 a group of 8 rows), whose
//      accumulators hold the item's retained modes.
//   2. mode_mix_hopper_kernel, per (mode, 32 output channels, 128 images):
//      the complex mixing as one real product (M 64 images, N 64, K 64 a
//      chunk of 32 input channels), always in split TF32 (float32 in both
//      modes, as the plain version mixes); the mode's weights, strided by
//      M1 M2 in device memory, gathered once into shared memory. It writes
//      the spectrum in the inverse's units.
//   3+4. inverse_hopper_kernel, persistent, two blocks an SM, a producer
//      warp and one consumer warpgroup: per item (image, 8 output rows, 32
//      output channels) the rows stage z = A . ym (M 64 = 2 modes x 32
//      channels, N 16, K 2 K) from spectrum units by cp.async.bulk, z split
//      into shared memory as the next stage's B, never to device memory;
//      then per 64-column tile and row the columns stage
//      [Br | -Bi | x_h] . [z; w0^T] (M 64, N 32), x by TMA boxes (2 rows x
//      64 columns x 32 channels, 128-byte swizzle) through a three-slot
//      ring, and the bias and exact erf GELU on the accumulators. Loads run
//      ahead by the ring, so one item's epilogue overlaps the next's loads.
// Measured at the flagship shape on an H100 80GB HBM3 at 700 W
// (scripts/bench_torch_kernels.py): 0.164-0.167 ms a call by CUDA events,
// passes 0.035 / 0.018 / 0.106 ms by torch.profiler, against 0.216-0.217
// ms on the sm_80 route in the same turns. The inverse holds it back: its 143 MB (x, out, the spectrum) take 43 us; its erf
// epilogue (16.7 M erff) costs about 35 us at eight consumer warps an SM,
// latency-bound, and its products wait on each batch (168 registers a
// thread at two blocks an SM leave no room for a second batch in flight).
// Without the producer warp (four warps, 255 registers) the inverse was
// slower: its loads were issued only after the products that read a slot.
//
// The sm_80 route, at the other shapes (and on request, to time both):
// mma.sync.m16n8k8 and cp.async (tf32.cuh) in four passes:
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
//      CUDA cores, four images per thread.
//   3. inverse_rows_kernel: the inverse H-stage, z = A (16 x 2K) . ym
//      (2K x m2 Co) per (image, 8-row tile), into device memory.
//   4. inverse_cols_kernel: per output row one GEMM folds the inverse
//      W-stage and the 1x1 bypass together,
//        out_h = [Br | -Bi | x_h] (W x (2 m2 + Ci)) . [z_r; z_i; w0^T],
//      with the bias and exact erf GELU applied to the accumulators, 32
//      output channels per grid row, persistent; where the tables and two
//      whole rows do not fit a block, inverse_cols_tiled_kernel runs the
//      same GEMM on items of two rows by 64 columns with its K in chunks.
// This route measured 0.208-0.217 ms at the flagship shape (passes 0.050 /
// 0.030 / 0.036 / 0.091 ms), bound by instruction issue and latency.
//
// Under spatial sharding a rank runs pass 1 on its rows, the ranks' partial
// spectra are summed, and it runs passes 2-4 for its rows: the host
// (ops/fno_kernels.py::_block_call) launches pass 1 (fno_block_spectrum_on)
// and passes 2-4 (fno_block_finish) apart, the sum between them. A rank's
// tables hold the DFT's columns (pass 1) and rows (the inverse) of its
// rows; rows past its count come in as zeros (TMA) or are masked.
// Shapes: every positive size runs on one route or the other; offsets into
// x, the spectra and the output are 64-bit. fno_block_unsupported refuses
// only sizes that are not positive, and the host refuses those before
// launching.
// The mixed DC and Nyquist columns keep pocketfft's C2R semantics through
// the alpha-weighted B table (ops/spectral.py::_dft_factors). w0 is split
// per block rather than cached on the host: it is the caller's tensor and
// may change between calls.

#include "hopper.cuh"

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

// The Hopper route's inverse (passes 3 and 4 fused). kHopRows and kHopW
// are mirrored in ops/fno_kernels.py.
constexpr int kHopConsumers = 128;                 // one consumer warpgroup
constexpr int kHopThreads = kHopConsumers + 32;    // and one producer warp
constexpr int kHopRows = 8;   // output rows per item: the rows stage's N = 16 (re/im, row)
constexpr int kHopHalf = 4;   // rows the columns stage holds accumulators for at a time
constexpr int kHopCo = 32;    // output channels per block (= kMixCo)
constexpr int kHopZt = kHopRows * kHopCo;  // rows (row, o) of z on chip
constexpr int kHopW = 64;     // columns per item tile: the columns stage's M
constexpr int kHopXr = 2;     // rows of x per box
constexpr int kHopXc = 32;    // channels per box: 128 bytes, the swizzle's span
constexpr int kHopSlot = kHopXr * kHopW * kHopXc * 4;  // ring slot: one x box, 16 KB
constexpr int kHopYc = kHopSlot / (64 * 4);  // spectrum rows (kk) a spectrum unit: 64
constexpr int kHopSlots = 3;
constexpr int kHopZb = 3;  // k-steps a batch of [Br | -Bi] . Zt: the flagship's, in one
static_assert(kHopCo == kMixCo, "pass 2 writes the spectrum units of one block's channels");

// The Hopper route's pass 1. kSpecC, kSpecRows and kSpecModes are mirrored
// in ops/fno_kernels.py.
constexpr int kSpecC = 16;      // channels an item: a box 64 bytes wide (64-byte swizzle)
constexpr int kSpecXr = 4;      // rows of x a box: the W-stage's M = 4 x 16 = 64
constexpr int kSpecRows = 8;    // rows a group: the H-stage's K = 16 (re/im, row)
constexpr int kSpecModes = 12;  // modes each way at most on this route
constexpr int kSpecNW = 2 * kSpecModes;                  // W-stage N: (re/im, m)
constexpr int kSpecNH = 4 * kSpecModes;                  // H-stage N: (re/im, k), 2 K <= 48
constexpr int kSpecMT = kSpecModes * kSpecC / 64;        // H-stage M tiles: (m, c)
constexpr int kSpecSlot = kSpecXr * kHopW * kSpecC * 4;  // a box, 16 KB
constexpr int kSpecSlots = 4;
constexpr int kSpecThreads = kHopThreads;  // one consumer warpgroup and one producer warp
constexpr int kSpecTr = 2 * kSpecModes * kSpecC + 8;  // floats a row of T: 8 mod 32, conflict-free
static_assert(kSpecSlot == kHopSlot, "one box size");

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

// Pass 1 of the Hopper route (at most kSpecModes modes each way): one
// persistent, warp-specialised kernel on wgmma and TMA.
//   Item: (image b, kSpecC channels c0 ..). A block walks items gridDim.x
//   apart; at the flagship shape every block takes one.
//   Producer warp (one thread): the W-stage table once (cp.async.bulk);
//   per group of kSpecRows rows, the H-stage table's group (cp.async.bulk,
//   two buffers) and the group's boxes of x (16 channels x 64 columns x 4
//   rows, 64-byte swizzle, zeros past the rows, columns and channels) by
//   TMA into a ring of kSpecSlots slots, each completed on its `full`
//   mbarrier and given back on its `empty` one.
//   W-stage, per box: T[(r, c), (re/im, m)] = sum_w x[r, w, c] E2[(re/im,
//   m), w] (M 64, N 24, K 8 a k-step) over the grid's 64-column tiles, x
//   from the ring into registers, split there; E2 (host-split) is B. T
//   goes to shared memory as float32.
//   H-stage, per group: xm[(m, c), (re/im, k)] += sum_j T[j, (m, c)] E1[(re/im,
//   k), j] over j = (re/im, row) of the group (M 3 x 64, N 48, K 16), T
//   from shared memory into registers, split there; E1 (host-split,
//   the group's columns of [[E1r, -E1i], [E1i, E1r]]) is B. Its
//   accumulators stay in registers across the groups; written to xm at the
//   end of the item.
// e2h: (2 halves, W64/4, kSpecNW, 4), W64 = W rounded up to 64: rows (re/im,
//      m) of [E2r; E2i], zero past m2; e1h: (ceil(H/8), 2 halves, 4,
//      kSpecNH, 4): rows (re/im, k), zero past 2 m1 (hopper.cuh's B layout).
template <int P>
__global__ void __launch_bounds__(kSpecThreads, 2) dft_forward_hopper_kernel(
    const __grid_constant__ CUtensorMap xmap, const float* __restrict__ e2h,
    const float* __restrict__ e1h, float* __restrict__ xm, int B, int H, int W, int Ci, int K,
    int m2) {
  FNO_DYNAMIC_SMEM(float4, smem4);
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_ct = ceil_div(Ci, kSpecC), n_wt = ceil_div(W, kHopW), n_g = ceil_div(H, kSpecRows);
  const int W64 = n_wt * kHopW;
  const long long n_items = (long long)B * n_ct;
  constexpr int kE1 = 2 * 16 * kSpecNH;  // floats of a group's table

  char* raw = reinterpret_cast<char*>(smem4);
  char* ring = raw + (1024 - smem_addr(raw) % 1024) % 1024;            // the swizzle's alignment
  float* e2s = reinterpret_cast<float*>(ring + kSpecSlots * kSpecSlot);  // 2 x [W64/4][kSpecNW][4]
  float* e1s = e2s + 2 * W64 * kSpecNW;                                 // 2 buffers of kE1
  float* ts = e1s + 2 * kE1;                                            // [row][re/im][m][c], rows kSpecTr
  Mbar* full = reinterpret_cast<Mbar*>(ts + kSpecRows * kSpecTr);
  Mbar* empty = full + kSpecSlots;
  Mbar* e1_full = empty + kSpecSlots;  // 2
  Mbar* e1_empty = e1_full + 2;        // 2
  Mbar* e2_full = e1_empty + 2;
  if (tid == 0) {
    for (int i = 0; i < kSpecSlots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kHopConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&e1_full[i], 1);
      mbar_init(&e1_empty[i], kHopConsumers / 32);
    }
    mbar_init(e2_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kHopConsumers / 32) {
    // Producer.
    if (lane == 0) {
      const uint32_t e2_bytes = 2 * W64 * kSpecNW * 4;
      mbar_arrive_expect_tx(e2_full, e2_bytes);
      bulk_load(e2s, e2h, e2_bytes, e2_full);
      int slot = 0, phase = 0;
      long long grp = 0;  // this block's groups so far: the H-stage table's buffer and phase
      for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
        const int b = (int)(it / n_ct), c0 = (int)(it % n_ct) * kSpecC;
        for (int gi = 0; gi < n_g; ++gi, ++grp) {
          const int eb = (int)(grp & 1);
          mbar_wait(&e1_empty[eb], (int)((grp >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(&e1_full[eb], kE1 * 4);
          bulk_load(e1s + eb * kE1, e1h + (size_t)gi * kE1, kE1 * 4, &e1_full[eb]);
          for (int q = 0; q < kSpecRows / kSpecXr; ++q) {
            for (int wt = 0; wt < n_wt; ++wt) {
              mbar_wait(&empty[slot], phase ^ 1);
              mbar_arrive_expect_tx(&full[slot], kSpecSlot);
              tma_load_4d(ring + slot * kSpecSlot, &xmap, &full[slot], c0, wt * kHopW,
                          gi * kSpecRows + q * kSpecXr, b);
              if (++slot == kSpecSlots) {
                slot = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
    }
    return;
  }

  // Consumers.
  int slot = 0, phase = 0;
  long long grp = 0;
  const uint64_t e2_hi = smem_desc(e2s, kSpecNW * 16, 128);
  const uint64_t e2_lo = smem_desc(e2s + W64 * kSpecNW, kSpecNW * 16, 128);
  mbar_wait(e2_full, 0);
  for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int b = (int)(it / n_ct), c0 = (int)(it % n_ct) * kSpecC;
    float hacc[kSpecMT][kSpecNH / 2];
#pragma unroll
    for (int mt = 0; mt < kSpecMT; ++mt)
#pragma unroll
      for (int i = 0; i < kSpecNH / 2; ++i) hacc[mt][i] = 0.f;
    for (int gi = 0; gi < n_g; ++gi, ++grp) {
      // W-stage, per box of 4 rows: this warp's row 4 q + w, channels g (+ 8).
      for (int q = 0; q < kSpecRows / kSpecXr; ++q) {
        float wacc[kSpecNW / 2];
#pragma unroll
        for (int i = 0; i < kSpecNW / 2; ++i) wacc[i] = 0.f;
        for (int wt = 0; wt < n_wt; ++wt) {
          mbar_wait(&full[slot], phase);
          const char* xs = ring + slot * kSpecSlot;
#pragma unroll
          for (int k0 = 0; k0 < kHopW / 8; k0 += 4) {
            uint32_t ahi[4][4], alo[4][4];
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int c = g + 8 * (i & 1), wc = (k0 + ks) * 8 + t + 4 * (i >> 1);
                const int o = ((warp * kHopW + wc) * kSpecC + c) * 4;
                const float v = *reinterpret_cast<const float*>(xs + (o ^ (((o >> 7) & 3) << 4)));
                split_tf32(v, ahi[ks][i], alo[ks][i]);
              }
            }
            if (k0 + 4 == kHopW / 8) {
              __syncwarp();
              if (lane == 0) mbar_arrive(&empty[slot]);
              if (++slot == kSpecSlots) {
                slot = 0;
                phase ^= 1;
              }
            }
            wgmma_batch_begin(wacc, kSpecNW / 2, ahi, alo);
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              const uint64_t step = (uint64_t)(wt * kHopW / 8 + k0 + ks) * 2 * kSpecNW * 16 >> 4;
              wgmma_tf32x<P, kSpecNW>(wacc, ahi[ks], alo[ks], e2_hi + step, e2_lo + step);
            }
            wgmma_batch_end(wacc, kSpecNW / 2);
          }
        }
        // wacc[4 j + 2 hf + e]: row (r = 4 q + w, c = g + 8 hf), column
        // n = 8 j + 2 t + e = (re/im, m).
#pragma unroll
        for (int i = 0; i < kSpecNW / 2; ++i) {
          const int n = 8 * (i >> 2) + 2 * t + (i & 1), c = g + 8 * ((i >> 1) & 1);
          ts[(q * kSpecXr + warp) * kSpecTr + n * kSpecC + c] = wacc[i];
        }
      }
      consumer_sync(kHopConsumers);  // every warp's rows of T written

      // H-stage: A[(m, c), (ri', r)] = T[r][ri'][m][c]: this warp's mode
      // 4 mt + w, channels g (+ 8); a k-step is one ri'.
      const int eb = (int)(grp & 1);
      mbar_wait(&e1_full[eb], (int)((grp >> 1) & 1));
      const float* e1b = e1s + eb * kE1;
      const uint64_t e1_hi = smem_desc(e1b, kSpecNH * 16, 128);
      const uint64_t e1_lo = smem_desc(e1b + 16 * kSpecNH, kSpecNH * 16, 128);
      uint32_t ahi[kSpecMT * 2][4], alo[kSpecMT * 2][4];
#pragma unroll
      for (int mt = 0; mt < kSpecMT; ++mt) {
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = 4 * mt + warp, c = g + 8 * (i & 1), r = t + 4 * (i >> 1);
            split_tf32(ts[r * kSpecTr + (ri * kSpecModes + m) * kSpecC + c], ahi[mt * 2 + ri][i],
                       alo[mt * 2 + ri][i]);
          }
        }
      }
      wgmma_batch_begin(&hacc[0][0], kSpecMT * kSpecNH / 2, ahi, alo);
#pragma unroll
      for (int mt = 0; mt < kSpecMT; ++mt) {
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const uint64_t step = (uint64_t)ri * 2 * kSpecNH * 16 >> 4;
          wgmma_tf32x<P, kSpecNH>(hacc[mt], ahi[mt * 2 + ri], alo[mt * 2 + ri], e1_hi + step,
                                  e1_lo + step);
        }
      }
      wgmma_batch_end(&hacc[0][0], kSpecMT * kSpecNH / 2);
      __syncwarp();
      if (lane == 0) mbar_arrive(&e1_empty[eb]);
    }
    // hacc[mt][4 j + 2 hf + e]: row (m = 4 mt + w, c = g + 8 hf), column
    // n = 8 j + 2 t + e = (re/im, k).
    float* xmb = xm + (size_t)b * 2 * K * m2 * Ci;
#pragma unroll
    for (int mt = 0; mt < kSpecMT; ++mt) {
#pragma unroll
      for (int i = 0; i < kSpecNH / 2; ++i) {
        const int n = 8 * (i >> 2) + 2 * t + (i & 1), c = c0 + g + 8 * ((i >> 1) & 1);
        const int ri = n / (2 * kSpecModes), k = n % (2 * kSpecModes), m = 4 * mt + warp;
        if (k < K && m < m2 && c < Ci) xmb[(((size_t)ri * K + k) * m2 + m) * Ci + c] = hacc[mt][i];
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

// Pass 2 of the Hopper route on wgmma: per retained mode (k, m), block of
// kHopCo output channels and 64 images, Y[b, (re/im, o)] = sum X[b, (re/im,
// c)] Wm[(re/im, o), (re/im, c)] (M 64, N 64, K 64 a chunk of 32 input
// channels), the complex product written out as a real one:
//   Wm = [[Wr, -Wi], [Wi, Wr]] (rows: real then imaginary output channels;
//   columns: real then imaginary input channels of the chunk).
// Always in split TF32 (three products): the mixing is float32 in both
// modes, as in the plain version. The block gathers its mode's weights
// (strided by M1 M2 in device memory, each read once, many loads in
// flight) into shared memory, split, as B; X comes from xm into
// registers, split there. It writes ym in the Hopper inverse's spectrum
// units (64 rows (m % 2, o) by kk, rows XOR 8 (kk % 4)).
constexpr int kMixN = 2 * kHopCo;  // (re/im, o)
constexpr int kMixC = 32;          // input channels a chunk: K = 64
constexpr int kMixT = 2;           // tiles of 64 images a block, the weights gathered once
__global__ void __launch_bounds__(128) mode_mix_hopper_kernel(
    const float* __restrict__ xm, const float* __restrict__ weights, float* __restrict__ ym,
    int B, int K, int m1, int m2, int Ci, int Co, int M1, int M2) {
  FNO_DYNAMIC_SMEM(float4, smem4);
  float* bs = reinterpret_cast<float*>(smem4);  // 2 halves x [2 kMixC / 4][kMixN][4]
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int km = blockIdx.x, k = km / m2, m = km % m2, corner = k >= m1 ? 1 : 0;
  const int o0 = blockIdx.y * kHopCo, n_ot = gridDim.y, b00 = blockIdx.z * 64 * kMixT;
  const int KY = round_up(2 * K, 16), n_mt = ceil_div(m2, 2);
  const size_t plane = (size_t)Ci * Co * M1 * M2, xplane = (size_t)K * m2 * Ci;
  const float* wc = weights + corner * 2 * plane + (size_t)(k - corner * m1) * M2 + m;
  constexpr int kPlane = 2 * kMixC * kMixN;
  const uint64_t b_hi = smem_desc(bs, kMixN * 16, 128), b_lo = smem_desc(bs + kPlane, kMixN * 16, 128);
  float acc[kMixT][kMixN / 2];
#pragma unroll
  for (int bt = 0; bt < kMixT; ++bt)
#pragma unroll
    for (int i = 0; i < kMixN / 2; ++i) acc[bt][i] = 0.f;
  for (int c0 = 0; c0 < Ci; c0 += kMixC) {
    __syncthreads();  // the previous chunk's products are done in every warp
    // Wm's columns of channels c0 .. c0 + 31, split; zero past the channels.
    constexpr int kPer = kMixC * kHopCo / 128;
    float wr[kPer], wi[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + 128 * q, o = i % kHopCo, c = c0 + i / kHopCo;
      const size_t at = ((size_t)c * Co + o0 + o) * M1 * M2;
      const bool ok = c < Ci && o0 + o < Co;
      wr[q] = ok ? __ldg(wc + at) : 0.f;
      wi[q] = ok ? __ldg(wc + plane + at) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + 128 * q, o = i % kHopCo, cl = i / kHopCo;
      // (row n, column kl) of Wm: (o, cl) Wr, (o, 32 + cl) -Wi, (32 + o, cl) Wi, (32 + o, 32 + cl) Wr.
      const float v[4] = {wr[q], -wi[q], wi[q], wr[q]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = o + kHopCo * (e >> 1), kl = cl + kMixC * (e & 1);
        uint32_t hi, lo;
        split_tf32(v[e], hi, lo);
        const int a = (kl / 4) * kMixN * 4 + n * 4 + kl % 4;
        bs[a] = __uint_as_float(hi);
        bs[kPlane + a] = __uint_as_float(lo);
      }
    }
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int bt = 0; bt < kMixT; ++bt) {
    // This thread's rows: images b0 + 16 w + g (+ 8).
    const int b0 = b00 + bt * 64;
    const float* xa = xm + (size_t)(b0 + 16 * warp + g) * 2 * xplane + (size_t)km * Ci;
    const bool ok0 = b0 + 16 * warp + g < B, ok1 = b0 + 16 * warp + g + 8 < B;
#pragma unroll
    for (int k0 = 0; k0 < 2 * kMixC / 8; k0 += 4) {
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kl = (k0 + ks) * 8 + t + 4 * (i >> 1), c = c0 + kl % kMixC;
          const bool ok = (i & 1 ? ok1 : ok0) && c < Ci;
          const float v = ok ? __ldg(xa + (i & 1) * 16 * xplane + (kl / kMixC) * xplane + c) : 0.f;
          split_tf32(v, ahi[ks][i], alo[ks][i]);
        }
      }
      wgmma_batch_begin(acc[bt], kMixN / 2, ahi, alo);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t step = (uint64_t)(k0 + ks) * 2 * kMixN * 16 >> 4;
        wgmma_tf32x<3, kMixN>(acc[bt], ahi[ks], alo[ks], b_hi + step, b_lo + step);
      }
      wgmma_batch_end(acc[bt], kMixN / 2);
    }
    }
  }
  // acc[4 j + 2 hf + e]: image b0 + 16 w + g + 8 hf, column n = 8 j + 2 t + e
  // = (re/im, o).
#pragma unroll
  for (int bt = 0; bt < kMixT; ++bt)
#pragma unroll
  for (int j = 0; j < kMixN / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int b = b00 + bt * 64 + 16 * warp + g + 8 * hf, n = 8 * j + 2 * t;
      const int ri = n / kHopCo, o = n % kHopCo, kk = ri * K + k;
      if (b < B && o0 + o < Co) {
        const int row = (m % 2) * kHopCo + o;
        const size_t unit = (((size_t)b * n_ot + blockIdx.y) * n_mt + m / 2) * KY;
        *reinterpret_cast<float2*>(ym + (unit + kk) * 64 + (row ^ (8 * (kk & 3)))) =
            make_float2(acc[bt][4 * j + 2 * hf], acc[bt][4 * j + 2 * hf + 1]);
      }
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

// The Hopper route's inverse: passes 3 and 4 in one persistent,
// warp-specialised kernel, the inverse's row spectra z kept on chip.
//   Item: (image b, kHopRows output rows h0 .., this block's kHopCo output
//   channels o0 ..). A block walks items gridDim.x apart.
//   Producer warp (one thread): per item, by cp.async.bulk, the item's
//   rows of the inverse H-stage table (a1h, its own buffer) and the
//   spectrum units of its channels (ym as pass 2 leaves it for this route:
//   64 rows (m % 2, o) by up to 64 kk, 16 KB); then by TMA, per 64-column
//   tile, boxes of x (32 channels x 64 columns x 2 rows, 16 KB, 128-byte
//   swizzle, zeros past the rows, columns and channels) into a ring of
//   kHopSlots slots, each completed on its `full` mbarrier and given back
//   on its `empty` one.
//   Rows stage: per pair of modes, Z[(m, o), (re/im, r)] = sum_kk Y[(m, o),
//   kk] A1[(re/im, r), kk] on wgmma (M 64, N 16, K 8 a k-step), Y from the
//   ring into registers, split there; A1 (host-split) is B. The result is
//   split and written to shared memory as the columns stage's B: Zt[(r,
//   o), (re/im, m)], both halves, never to device memory.
//   Columns stage, per 64-column tile and row r: D_r[w, o] = [Br |
//   -Bi][w, :] Zt[(r, o), :] + x_r[w, :] w0[o, :] (M 64, N 32; 4 rows'
//   accumulators at a time, [Br | -Bi]'s three k-steps one batch for
//   them, x a row a batch), [Br | -Bi] as split A
//   fragments from the table, x from the ring split in registers, w0 split
//   once a block into shared memory; then the bias and exact erf GELU into
//   out (and pre).
// The producer runs ahead by the ring, so one item's epilogue overlaps the
// next item's loads; two blocks share an SM at the flagship shape.
// a1h: (ceil(H/8), 2 halves, KY/4, 16, 4), the B layout of hopper.cuh (rows
//      (re/im, r) of [[Ar, -Ai], [Ai, Ar]], KY = 2 K rounded up to 16).
// bwf: as for inverse_cols_kernel, its rows padded to 64.
template <int P>
__global__ void __launch_bounds__(kHopThreads, 2) inverse_hopper_kernel(
    const __grid_constant__ CUtensorMap xmap, const float* __restrict__ ym,
    const float* __restrict__ a1h, const float4* __restrict__ bwf, const float* __restrict__ w0,
    const float* __restrict__ b0, float* __restrict__ out, float* __restrict__ pre, int B, int H,
    int W, int Ci, int Co, int K, int m2) {
  FNO_DYNAMIC_SMEM(float4, smem4);
  // The warp index through a shuffle, which the compiler knows is uniform
  // across the warp: wgmma under a branch it cannot prove uniform is
  // serialized.
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.y * kHopCo, n_ot = gridDim.y;
  // K extents, zero-padded so that every batch of products runs unguarded:
  // KY (spectrum rows) in pairs of k-steps, KZ (z's columns) in k-steps (a
  // batch's k-steps past it multiply a zero A), KX (channels) in whole boxes.
  const int KY = round_up(2 * K, 16), KZ = round_up(2 * m2, 8), KX = round_up(Ci, kHopXc);
  const int n_mt = ceil_div(m2, 2), n_rt = ceil_div(H, kHopRows), n_wt = ceil_div(W, kHopW);
  const int n_cc = ceil_div(Ci, kHopXc);
  const long long n_items = (long long)B * n_rt;

  char* raw = reinterpret_cast<char*>(smem4);
  char* ring = raw + (1024 - smem_addr(raw) % 1024) % 1024;  // the swizzle's alignment
  float* zt = reinterpret_cast<float*>(ring + kHopSlots * kHopSlot);  // 2 x [KZ/4][kHopZt][4]
  float* w0s = zt + 2 * kHopZt * KZ;                                  // 2 x [KX/4][kHopCo][4]
  float* a1s = w0s + 2 * kHopCo * KX;                                 // 2 x [KY/4][16][4]
  float* bias = a1s + 2 * 16 * KY;
  Mbar* full = reinterpret_cast<Mbar*>(bias + kHopCo);
  Mbar* empty = full + kHopSlots;
  Mbar* a1_full = empty + kHopSlots;
  Mbar* a1_empty = a1_full + 1;

  for (int i = tid; i < 2 * kHopZt * KZ; i += kHopThreads) zt[i] = 0.f;
  for (int i = tid; i < kHopCo * KX; i += kHopThreads) {
    const int o = i % kHopCo, c = i / kHopCo;
    const float v = o0 + o < Co && c < Ci ? w0[(size_t)(o0 + o) * Ci + c] : 0.f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int at = (c / 4) * kHopCo * 4 + o * 4 + c % 4;
    w0s[at] = __uint_as_float(hi);
    w0s[kHopCo * KX + at] = __uint_as_float(lo);
  }
  for (int i = tid; i < kHopCo; i += kHopThreads) bias[i] = o0 + i < Co ? b0[o0 + i] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < kHopSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kHopConsumers / 32);
    }
    mbar_init(a1_full, 1);
    mbar_init(a1_empty, kHopConsumers / 32);
    fence_mbar_init();
  }
  fence_proxy_async();  // the zeroed z and the split w0, read by wgmma
  __syncthreads();

  const uint32_t a1_bytes = 2 * 16 * KY * 4;
  if (warp == kHopConsumers / 32) {
    // Producer.
    if (lane == 0) {
      int slot = 0, phase = 0, a1_phase = 0;
      auto take = [&](uint32_t bytes) -> char* {
        mbar_wait(&empty[slot], phase ^ 1);
        mbar_arrive_expect_tx(&full[slot], bytes);
        return ring + slot * kHopSlot;
      };
      auto next = [&] {
        if (++slot == kHopSlots) {
          slot = 0;
          phase ^= 1;
        }
      };
      for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
        const int b = (int)(it / n_rt), rt = (int)(it % n_rt);
        mbar_wait(a1_empty, a1_phase ^ 1);
        a1_phase ^= 1;
        mbar_arrive_expect_tx(a1_full, a1_bytes);
        bulk_load(a1s, a1h + (size_t)rt * 2 * 16 * KY, a1_bytes, a1_full);
        const float* yb = ym + ((size_t)b * n_ot + blockIdx.y) * n_mt * KY * 64;
        for (int mt = 0; mt < n_mt; ++mt) {
          for (int kc = 0; kc < KY; kc += kHopYc) {
            const uint32_t bytes = min(kHopYc, KY - kc) * 64 * 4;
            bulk_load(take(bytes), yb + ((size_t)mt * KY + kc) * 64, bytes, &full[slot]);
            next();
          }
        }
        for (int wt = 0; wt < n_wt; ++wt) {
          for (int rp = 0; rp < kHopRows / kHopXr; ++rp) {
            for (int cc = 0; cc < n_cc; ++cc) {
              tma_load_4d(take(kHopSlot), &xmap, &full[slot], cc * kHopXc, wt * kHopW,
                          rt * kHopRows + rp * kHopXr, b);
              next();
            }
          }
        }
      }
    }
    return;
  }

  // Consumers: warp w of the warpgroup owns rows 16 w .. 16 w + 15 of each
  // product's M.
  int slot = 0, phase = 0, a1_phase = 0;
  auto release = [&] {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (++slot == kHopSlots) {
      slot = 0;
      phase ^= 1;
    }
  };
  const uint64_t a1_hi = smem_desc(a1s, 16 * 16, 128), a1_lo = smem_desc(a1s + 16 * KY, 16 * 16, 128);
  const uint64_t zt_hi = smem_desc(zt, kHopZt * 16, 128);
  const uint64_t zt_lo = smem_desc(zt + kHopZt * KZ, kHopZt * 16, 128);
  const uint64_t w0_hi = smem_desc(w0s, kHopCo * 16, 128);
  const uint64_t w0_lo = smem_desc(w0s + kHopCo * KX, kHopCo * 16, 128);
  for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int b = (int)(it / n_rt), h0 = (int)(it % n_rt) * kHopRows;

    // Rows stage, a batch of two k-steps at a time (A's registers live
    // until the batch's products are done).
    mbar_wait(a1_full, a1_phase);
    a1_phase ^= 1;
    // z's rows of modes 2 mt, 2 mt + 1 into Zt, split.
    auto put_z = [&](const float (&zacc)[8], int mt) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = 16 * warp + g + 8 * ((i >> 1) & 1), m = 2 * mt + row / kHopCo;
        const int o = row % kHopCo, ri = i >> 2, r = 2 * t + (i & 1);
        if (m < m2 && o0 + o < Co) {
          const int kk = ri * m2 + m, at = (kk / 4) * kHopZt * 4 + (r * kHopCo + o) * 4 + kk % 4;
          uint32_t hi, lo;
          split_tf32(zacc[i], hi, lo);
          zt[at] = __uint_as_float(hi);
          zt[kHopZt * KZ + at] = __uint_as_float(lo);
        }
      }
    };
    for (int mt = 0; mt < n_mt; ++mt) {
      float zacc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) zacc[i] = 0.f;
      for (int kc = 0; kc < KY; kc += kHopYc) {
        mbar_wait(&full[slot], phase);
        const float* ys = reinterpret_cast<const float*>(ring + slot * kHopSlot);
        const int ks_n = min(kHopYc, KY - kc) / 8;
        for (int k0 = 0; k0 < ks_n; k0 += 2) {
          uint32_t ahi[2][4], alo[2][4];
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = 16 * warp + g + 8 * (i & 1), kk = (k0 + ks) * 8 + t + 4 * (i >> 1);
              const float v = kc + kk < 2 * K ? ys[kk * 64 + (row ^ (8 * (kk & 3)))] : 0.f;
              split_tf32(v, ahi[ks][i], alo[ks][i]);
            }
          }
          if (k0 + 2 >= ks_n) release();
          wgmma_batch_begin(zacc, 8, ahi, alo);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const uint64_t step = (uint64_t)(kc / 8 + k0 + ks) * 2 * 16 * 16 >> 4;
            wgmma_tf32x<P, 16>(zacc, ahi[ks], alo[ks], a1_hi + step, a1_lo + step);
          }
          wgmma_batch_end(zacc, 8);
        }
      }
      put_z(zacc, mt);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(a1_empty);
    fence_proxy_async();
    consumer_sync(kHopConsumers);  // every warp's z written

    // Columns stage: each of a half's 4 rows its own 64 x 32 accumulators
    // (M 64, N 32 in every product; one accumulator array read at two
    // widths made ptxas serialize the products).
    for (int wt = 0; wt < n_wt; ++wt) {
      const float4* bwt = bwf + ((size_t)(wt * 4 + warp) * (KZ / 8) * 32 + lane) * 2;
#pragma unroll
      for (int half = 0; half < kHopRows / kHopHalf; ++half) {
        float acc[kHopHalf][kHopCo / 2];
#pragma unroll
        for (int rl = 0; rl < kHopHalf; ++rl)
#pragma unroll
          for (int i = 0; i < kHopCo / 2; ++i) acc[rl][i] = 0.f;
        // [Br | -Bi] . Zt of each row, up to kHopZb k-steps a batch.
        for (int k0 = 0; k0 < KZ / 8; k0 += kHopZb) {
          uint32_t bhi[kHopZb][4], blo[kHopZb][4];
#pragma unroll
          for (int ks = 0; ks < kHopZb; ++ks) {
            if (k0 + ks < KZ / 8) {
              load_a_frag(bwt + (size_t)(k0 + ks) * 64, bhi[ks], blo[ks]);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i) bhi[ks][i] = blo[ks][i] = 0u;
            }
          }
          wgmma_batch_begin(&acc[0][0], kHopHalf * kHopCo / 2, bhi, blo);
#pragma unroll
          for (int ks = 0; ks < kHopZb; ++ks) {
#pragma unroll
            for (int rl = 0; rl < kHopHalf; ++rl) {
              const int kz = min(k0 + ks, KZ / 8 - 1);  // a zero A past KZ: any B
              const uint64_t step = ((uint64_t)(half * kHopHalf + rl) * kHopCo * 16 +
                                     (uint64_t)kz * 2 * kHopZt * 16) >> 4;
              wgmma_tf32x<P, kHopCo>(acc[rl], bhi[ks], blo[ks], zt_hi + step, zt_lo + step);
            }
          }
          wgmma_batch_end(&acc[0][0], kHopHalf * kHopCo / 2);
        }
        // x_r . w0^T for each row r of the half: a box (2 rows, 32
        // channels) at a time, a row a batch.
#pragma unroll
        for (int rp = 0; rp < kHopHalf / kHopXr; ++rp) {
          for (int cc = 0; cc < n_cc; ++cc) {
            mbar_wait(&full[slot], phase);
            const char* xs = ring + slot * kHopSlot;
#pragma unroll
            for (int rr = 0; rr < kHopXr; ++rr) {
              uint32_t xhi[4][4], xlo[4][4];
#pragma unroll
              for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int q = rr * kHopW + 16 * warp + g + 8 * (i & 1);
                  const int c = ks * 8 + t + 4 * (i >> 1);
                  const float v =
                      *reinterpret_cast<const float*>(xs + ((q * 128 + c * 4) ^ ((q & 7) << 4)));
                  split_tf32(v, xhi[ks][i], xlo[ks][i]);
                }
              }
              if (rr == kHopXr - 1) release();
              float* racc = acc[rp * kHopXr + rr];
              wgmma_batch_begin(racc, kHopCo / 2, xhi, xlo);
#pragma unroll
              for (int ks = 0; ks < 4; ++ks) {
                const uint64_t step = (uint64_t)(cc * 4 + ks) * 2 * kHopCo * 16 >> 4;
                wgmma_tf32x<P, kHopCo>(racc, xhi[ks], xlo[ks], w0_hi + step, w0_lo + step);
              }
              wgmma_batch_end(racc, kHopCo / 2);
            }
          }
        }
        // acc[rl][4 j + 2 hf + e]: column w = 16 w + g + 8 hf of the
        // tile, row h0 + 4 half + rl, channel o0 + 8 j + 2 t + e. The bias
        // and GELU over all 64 values before any store, without branches,
        // so that their latencies overlap (the warpgroup is alone with
        // one other on its SM).
        const int w_lo = wt * kHopW + 16 * warp + g;
        size_t row_at[kHopHalf];
        bool row_ok[kHopHalf];
#pragma unroll
        for (int rl = 0; rl < kHopHalf; ++rl) {
          const int h = h0 + half * kHopHalf + rl;
          row_ok[rl] = h < H;
          row_at[rl] = (((size_t)b * H + h) * W + w_lo) * Co + o0 + 2 * t;
        }
#pragma unroll
        for (int rl = 0; rl < kHopHalf; ++rl)
#pragma unroll
          for (int i = 0; i < kHopCo / 2; ++i) acc[rl][i] += bias[8 * (i >> 2) + 2 * t + (i & 1)];
        auto store = [&](float* dst) {
#pragma unroll
          for (int rl = 0; rl < kHopHalf; ++rl) {
#pragma unroll
            for (int j = 0; j < kHopCo / 8; ++j) {
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                if (row_ok[rl] && w_lo + 8 * hf < W && o0 + 8 * j + 2 * t < Co) {
                  *reinterpret_cast<float2*>(dst + row_at[rl] + (size_t)8 * hf * Co + 8 * j) =
                      make_float2(acc[rl][4 * j + 2 * hf], acc[rl][4 * j + 2 * hf + 1]);
                }
              }
            }
          }
        };
        if (pre) store(pre);
#pragma unroll
        for (int rl = 0; rl < kHopHalf; ++rl)
#pragma unroll
          for (int i = 0; i < kHopCo / 2; ++i) acc[rl][i] = gelu_erf(acc[rl][i]);
        store(out);
      }
    }
  }
}

// Shared memory of each pass at one shape, and whether pass 4 runs tiled;
// `why` names a size that is not positive, or is null.
struct BlockPlan {
  size_t s1, s2, s4;
  bool tiled;
  const char* why;
};

// The Hopper inverse's shared memory: the ring, z's halves, w0's halves,
// the rows-stage table's halves, the bias and the barriers, and the slack
// that aligns the ring to 1024 bytes.
size_t hopper_smem(int Ci, int K, int m2) {
  const size_t KY = round_up(2 * K, 16), KZ = round_up(2 * m2, 8), KX = round_up(Ci, kHopXc);
  return 1024 + kHopSlots * kHopSlot +
         sizeof(float) * (2 * kHopZt * KZ + 2 * kHopCo * KX + 2 * 16 * KY + kHopCo) +
         (2 * kHopSlots + 2) * sizeof(Mbar);
}

// The Hopper pass 1's shared memory: the ring, the W-stage table's halves,
// two H-stage tables, T, the barriers, the alignment slack.
size_t spectrum_smem(int W) {
  const size_t W64 = round_up(W, kHopW);
  return 1024 + kSpecSlots * kSpecSlot +
         sizeof(float) * (2 * W64 * kSpecNW + 2 * 2 * 16 * kSpecNH + kSpecRows * kSpecTr) +
         (2 * kSpecSlots + 5) * sizeof(Mbar);
}

// Whether the Hopper pass 1 takes a shape: channels a multiple of 4 (TMA's
// 16-byte strides), at most kSpecModes modes each way, and its tables and
// ring in a block's shared memory.
bool spectrum_takes(int W, int Ci, int m1, int m2) {
  return Ci % 4 == 0 && m1 <= kSpecModes && m2 <= kSpecModes &&
         spectrum_smem(W) <= kMaxDynamicSmem;
}

// Whether the Hopper route takes a shape: TMA wants 16-byte strides (input
// channels a multiple of 4), the epilogue stores channel pairs (output
// channels a multiple of 4, as pass 2's units of 32), and the ring, z and
// the tables must fit a block.
bool hopper_takes(int Ci, int Co, int m1, int m2) {
  return Ci % 4 == 0 && Co % 4 == 0 && hopper_smem(Ci, 2 * m1, m2) <= kMaxDynamicSmem;
}

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

// Passes 2-4 in P TF32 products (fno_block_finish), on the old passes or,
// with `hopper`, pass 2 and the Hopper inverse.
template <int P>
int block_finish(const float* x, const float* xm, const float* weights, const float* w0,
                 const float* b0, const float* a1f, const float* bwf, const float* a1h, float* ym,
                 float* z, float* out, float* pre, int B, int H, int W, int Ci, int Co, int M1,
                 int M2, int m1, int m2, const BlockPlan& plan, bool hopper, cudaStream_t stream) {
  const int K = 2 * m1, n_ot = ceil_div(Co, kOutCo);
  const dim3 mix_grid(K * m2, ceil_div(B, kBatchTile), ceil_div(Co, kMixCo));
  cudaError_t err;
  if (hopper) {
    const auto mix = mode_mix_hopper_kernel;
    const auto inv = inverse_hopper_kernel<P>;
    const size_t s_hop = hopper_smem(Ci, K, m2);
    if ((err = allow_dynamic_smem((const void*)inv, s_hop))) return err;
    CUtensorMap xmap;
    const uint64_t dims[4] = {(uint64_t)Ci, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)Ci * 4, (uint64_t)W * Ci * 4, (uint64_t)H * W * Ci * 4};
    const uint32_t box[4] = {kHopXc, kHopW, kHopXr, 1};
    if ((err = (cudaError_t)encode_tensor_map_4d(&xmap, x, dims, strides, box, 128))) return err;
    int blocks = 0;  // all output-channel tiles together
    const long long n_items = (long long)B * ceil_div(H, kHopRows) * n_ot;
    if ((err = persistent_blocks(inv, kHopThreads, s_hop, n_items, &blocks))) return err;
    const size_t s_mix = 2 * 2 * kMixC * kMixN * sizeof(float);
    if ((err = allow_dynamic_smem((const void*)mix, s_mix))) return err;
    FNO_LAUNCH(mix, dim3(K * m2, n_ot, ceil_div(B, 64 * kMixT)), 128, s_mix, stream)(
        xm, weights, ym, B, K, m1, m2, Ci, Co, M1, M2);
    if ((err = cudaGetLastError())) return err;
    const dim3 grid(blocks > n_ot ? blocks / n_ot : 1, n_ot);
    FNO_LAUNCH(inv, grid, kHopThreads, s_hop, stream)(
        xmap, ym, a1h, reinterpret_cast<const float4*>(bwf), w0, b0, out, pre, B, H, W, Ci, Co,
        K, m2);
    return cudaGetLastError();
  }
  const int nh = ceil_div(H, kOutRows);
  const long long n_items = (long long)B * nh * (plan.tiled ? ceil_div(W, kOutCols) : 1);
  const auto cols = plan.tiled ? inverse_cols_tiled_kernel<P> : inverse_cols_kernel<P>;
  if ((err = allow_dynamic_smem((const void*)mode_mix_kernel, plan.s2))) return err;
  if ((err = allow_dynamic_smem((const void*)cols, plan.s4))) return err;
  int cols_blocks = 0;  // all output-channel tiles together
  if ((err = persistent_blocks(cols, kThreads, plan.s4, n_items * n_ot, &cols_blocks))) return err;
  FNO_LAUNCH(mode_mix_kernel, mix_grid, kThreads, plan.s2, stream)(
      xm, weights, ym, B, K, m1, m2, Ci, Co, M1, M2);
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

// The tiles that ops/fno_kernels.py::_block_tables lays the DFT tables
// out for: kFwdRows, kFwdModes, kFwdK, kFwdMT, kFwdNW, kInvRows, kHopRows,
// kHopW, kSpecRows, kSpecModes.
void fno_block_tiles(int* tiles) {
  const int t[] = {kFwdRows, kFwdModes, kFwdK,  kFwdMT,    kFwdNW,
                   kInvRows, kHopRows,  kHopW, kSpecRows, kSpecModes};
  for (int i = 0; i < 10; ++i) tiles[i] = t[i];
}

// Null when fno_block_spectrum and fno_block_finish take a grid W wide
// with Ci input channels and m2 retained modes along W (every positive
// size), else why they do not.
const char* fno_block_unsupported(int W, int Ci, int m2) { return plan_block(W, Ci, m2).why; }

// The routes the block takes at a shape, chosen by the shape alone: bit 0
// set, fno_block_finish runs the Hopper route (pass 2 and the fused
// inverse on wgmma and TMA), else the sm_80-style passes 2-4 (mma.sync,
// cp.async), which take channel counts that are not a multiple of 4 and
// shapes whose tables do not fit the Hopper inverse's shared memory; bit
// 1 set, fno_block_spectrum runs the Hopper pass 1 (up to 12 modes each
// way), else the sm_80-style one. -1 for a shape no route takes.
int fno_block_route(int W, int Ci, int Co, int m1, int m2) {
  if (plan_block(W, Ci, m2).why || Co < 1 || m1 < 1) return -1;
  return (hopper_takes(Ci, Co, m1, m2) ? 1 : 0) | (spectrum_takes(W, Ci, m1, m2) ? 2 : 0);
}

// The block runs in two calls around its retained spectrum, so that under
// spatial sharding (a rank holding rows r0 .. r0+H-1 of a taller grid) the
// ranks' partial spectra can be summed between them: pass 1 is a sum over
// rows. Without a split the host calls one after the other.
//
// fno_block_spectrum_on, pass 1 on `route` (0 the sm_80-style pass, 1 the
// Hopper one, taken only where fno_block_route's bit 1 is set): xm (B, 2,
// 2*m1, m2, Ci) = x's retained modes, rows 0..m1-1 and H-m1..H-1 of rfft2
// (of the global grid's rows), real then imaginary parts, summed over the
// H rows of x (B, H, W, Ci) that this call holds. e1f, e2f:
// ops/fno_kernels.py::_block_tables for those rows, the route's (e1f, e2f
// on route 0, e1h, e2h on route 1). products: 3 for split TF32, 1 for
// TF32 (tf32.cuh), else refused.
int fno_block_spectrum_on(const float* x, const float* e1f, const float* e2f, float* xm, int B,
                          int H, int W, int Ci, int m1, int m2, int products, int route,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const BlockPlan plan = plan_block(W, Ci, m2);
  if (plan.why || route < 0 || route > 1 || (route == 1 && !spectrum_takes(W, Ci, m1, m2))) {
    return cudaErrorInvalidValue;
  }
  const int K = 2 * m1, n_kc = ceil_div(K, kFwdK), n_mc = ceil_div(m2, kFwdModes);
  const bool stream_w = ceil_div(W, 8) > kFwdWK;
  const dim3 forward_grid(B, ceil_div(Ci, kFwdChan), n_kc * n_mc);
  const float4* e1q = reinterpret_cast<const float4*>(e1f);
  const float4* e2q = reinterpret_cast<const float4*>(e2f);
  return with_products(products, [&](auto p) -> int {
    constexpr int P = decltype(p)::value;
    cudaError_t err;
    if (route == 1) {
      const auto forward = dft_forward_hopper_kernel<P>;
      const size_t smem = spectrum_smem(W);
      if ((err = allow_dynamic_smem((const void*)forward, smem))) return err;
      CUtensorMap xmap;
      const uint64_t dims[4] = {(uint64_t)Ci, (uint64_t)W, (uint64_t)H, (uint64_t)B};
      const uint64_t strides[3] = {(uint64_t)Ci * 4, (uint64_t)W * Ci * 4,
                                   (uint64_t)H * W * Ci * 4};
      const uint32_t box[4] = {kSpecC, kHopW, kSpecXr, 1};
      if ((err = (cudaError_t)encode_tensor_map_4d(&xmap, x, dims, strides, box, 64))) return err;
      int blocks = 0;
      const long long n_items = (long long)B * ceil_div(Ci, kSpecC);
      if ((err = persistent_blocks(forward, kSpecThreads, smem, n_items, &blocks))) return err;
      FNO_LAUNCH(forward, blocks, kSpecThreads, smem, stream)(xmap, e2f, e1f, xm, B, H, W, Ci, K,
                                                               m2);
      return cudaGetLastError();
    }
    const auto forward = stream_w ? dft_forward_kernel<true, P> : dft_forward_kernel<false, P>;
    if ((err = allow_dynamic_smem((const void*)forward, plan.s1))) return err;
    FNO_LAUNCH(forward, forward_grid, kFwdThreads, plan.s1, stream)(x, e1q, e2q, xm, H, W, Ci, K,
                                                                     m2, n_mc);
    return cudaGetLastError();
  });
}

// fno_block_spectrum_on at the route fno_block_route's bit 1 gives the
// shape.
int fno_block_spectrum(const float* x, const float* e1f, const float* e2f, float* xm, int B,
                       int H, int W, int Ci, int m1, int m2, int products, void* stream_ptr) {
  return fno_block_spectrum_on(x, e1f, e2f, xm, B, H, W, Ci, m1, m2, products,
                               spectrum_takes(W, Ci, m1, m2) ? 1 : 0, stream_ptr);
}

// fno_block_finish, passes 2-4 on the whole retained spectrum xm, for the H
// rows of x (B, H, W, Ci) that this call holds, on `route`
// (fno_block_route's; 0 is taken at any shape, 1 only where the shape's
// route is 1): weights (2, 2, Ci, Co, M1, M2); w0 (Co, Ci); b0 (Co,); a1f,
// bwf, a1h: ops/fno_kernels.py::_block_tables for those rows; scratch ym
// (route 0: (B, 2, 2*m1, m2, Co); route 1: (B, ceil(Co/32), ceil(m2/2),
// 4*m1 rounded up to 16, 64)) and z (route 0: (B, H, 2, m2, Co); route 1:
// unused); out and, unless null, pre (the pre-activation): (B, H, W, Co).
// All float32, contiguous, on the current device, x 16-byte aligned;
// products as for fno_block_spectrum. Launches on `stream`, does not sync.
int fno_block_finish(const float* x, const float* xm, const float* weights, const float* w0,
                     const float* b0, const float* a1f, const float* bwf, const float* a1h,
                     float* ym, float* z, float* out, float* pre, int B, int H, int W, int Ci,
                     int Co, int M1, int M2, int m1, int m2, int products, int route,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const BlockPlan plan = plan_block(W, Ci, m2);
  if (plan.why || route < 0 || route > 1 || (route == 1 && !hopper_takes(Ci, Co, m1, m2))) {
    return cudaErrorInvalidValue;
  }
  return with_products(products, [&](auto p) -> int {
    constexpr int P = decltype(p)::value;
    return block_finish<P>(x, xm, weights, w0, b0, a1f, bwf, a1h, ym, z, out, pre, B, H, W, Ci,
                           Co, M1, M2, m1, m2, plan, route == 1, stream);
  });
}

}  // extern "C"
