// Fused FnoBlock forward for Hopper (sm_90a):
//   out = GELU(irfft2(mix(rfft2(x) on the retained modes)) + x @ w0^T + b0)
//
// Replaces: cfdbench_tpu/ops/pallas_fno.py::fused_fno_block (body
// `_kernel`), the TPU kernel that runs one whole FnoBlock per batch
// element with every intermediate in VMEM.
//
// What bounds it on this card: at the flagship shape (B=128, 64x64,
// 32->32 channels, 12x12 modes) one block is about 33 MFLOP of FP32
// multiply-adds per batch element (truncated DFTs both ways, per-mode
// complex mixing, 1x1 bypass): 4.2 GFLOP per call, about 63 us at the
// card's 67 TFLOP/s FP32 rate. It must read x (67 MB) and write the
// activation (67 MB), about 40 us at 3.35 TB/s. So it sits near the
// ridge; a plain PyTorch block moves roughly 1 GB through device memory
// (full rfft2 spectrum, zero-filled half spectrum, irfft2, bypass, add,
// GELU as separate passes).
//
// Design: one (B, H, W, C) image does not fit one block's 227 KB of
// shared memory (512 KB at the flagship shape), so the TPU kernel's
// "whole image on chip" becomes three passes that only keep the retained
// modes (2*m1 x m2 per channel, 74 KB per image) in device memory:
//   1. dft_forward_kernel: one block per (image, 16-channel tile). It
//      streams x eight rows at a time through shared memory, does the
//      column DFT of each row and accumulates the row DFT into the
//      block's modes, which stay in shared memory until the end.
//   2. mode_mix_kernel: one block per (retained mode, 16-image tile);
//      a complex (images x Ci) @ (Ci x Co) product per mode.
//   3. dft_inverse_kernel: one block per (image, 8-row tile). Inverse
//      row DFT of the modes into shared memory, then per output row the
//      inverse column DFT (real part, pocketfft C2R weights), the 1x1
//      bypass from the same row of x, the bias and exact erf GELU.
// Shared memory, not FMA, bounds such loops when each FMA needs its own
// load, so passes 1 and 3 give each thread a register tile (4 modes, 4
// spectrum rows, or 4 x 4 outputs) fed by float4 loads: 4-8 FMA per load,
// and the inner loops unroll by 4. Measured on an H100 80GB HBM3 at
// 700 W at the flagship shape, this took the block from 0.57 to 0.39 ms
// (the plain version: 0.96 ms); the inverse pass, 0.21 ms of it, stays
// about 5x above its FMA floor for reasons not yet measured.
// All sums are FP32 FMAs on the CUDA cores; tensor cores (wgmma) and
// TMA are later work. The DFT factor tables are
// cfdbench_tpu_torch/ops/spectral.py::_dft_factors_packed, passed in.

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChanTile = 16;   // input channels per block (pass 1)
constexpr int kRowGroup = 8;    // rows of x staged at a time (pass 1)
constexpr int kBatchTile = 16;  // images per block (pass 2)
constexpr int kRowTile = 8;     // output rows per block (pass 3)
constexpr int kRowPair = 2;     // rows of x staged at a time (pass 3)

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Pass 1. xm[b, k, m, c, re/im] = sum_h E1[k, h] sum_w E2[m, w] x[b, h, w, c]
// e1c: (2K, H) = [E1r; E1i]; e2c: (2*m2, 2W) = [[E2r, -E2i], [E2i, E2r]].
// Shared-memory tables are stored transposed and padded to whole float4s
// (m2p = roundup(m2, 4), Kp = roundup(K, 4)), so that a thread reads 4
// modes or 4 rows of the spectrum with one load.
__global__ void __launch_bounds__(kThreads) dft_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ e1c,
    const float* __restrict__ e2c, float* __restrict__ xm, int H, int W,
    int Ci, int K, int m2) {
  extern __shared__ float4 smem4[];
  constexpr int CT = kChanTile;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int ct = min(CT, Ci - c0);
  const int m2p = round4(m2), Kp = round4(K);
  float* e1r = reinterpret_cast<float*>(smem4);  // H * Kp, [h][k]
  float* e1i = e1r + H * Kp;             // H * Kp
  float* e2r = e1i + H * Kp;             // W * m2p, [w][m]
  float* e2i = e2r + W * m2p;            // W * m2p
  float* xs = e2i + W * m2p;             // kRowGroup * W * CT, [row][w][c]
  float* tr = xs + kRowGroup * W * CT;   // kRowGroup * m2p * CT, [row][m][c]
  float* ti = tr + kRowGroup * m2p * CT;
  float* ar = ti + kRowGroup * m2p * CT; // Kp * m2 * CT, [k][m][c]
  float* ai = ar + Kp * m2 * CT;

  for (int i = tid; i < H * Kp; i += kThreads) {
    const int h = i / Kp, k = i % Kp;
    e1r[i] = k < K ? e1c[k * H + h] : 0.f;
    e1i[i] = k < K ? e1c[(K + k) * H + h] : 0.f;
  }
  for (int i = tid; i < W * m2p; i += kThreads) {
    const int w = i / m2p, m = i % m2p;
    e2r[i] = m < m2 ? e2c[m * 2 * W + w] : 0.f;
    e2i[i] = m < m2 ? e2c[(m2 + m) * 2 * W + w] : 0.f;
  }
  // Row-DFT items: (4 spectrum rows k, mode m, channel c). Each thread
  // owns the items tid + j * kThreads in every loop over them below, so
  // their accumulators need no barrier of their own.
  const int n_items = (Kp / 4) * m2 * CT;
  for (int i = tid; i < Kp * m2 * CT; i += kThreads) {
    ar[i] = 0.f;
    ai[i] = 0.f;
  }
  __syncthreads();
  const float* xb = x + (size_t)b * H * W * Ci;
  for (int h0 = 0; h0 < H; h0 += kRowGroup) {
    const int r = min(kRowGroup, H - h0);
    __syncthreads();  // tables loaded; previous group's readers done
    for (int i = tid; i < r * W * CT; i += kThreads) {
      const int c = i % CT, rw = i / CT;  // rw = row_in_group * W + w
      xs[i] = c < ct ? xb[((size_t)h0 * W + rw) * Ci + c0 + c] : 0.f;
    }
    __syncthreads();
    // Column DFT of each staged row, 4 modes per item:
    // t[rr, m, c] = sum_w E2[m, w] x[rr, w, c]
    for (int i = tid; i < r * (m2p / 4) * CT; i += kThreads) {
      const int c = i % CT, mq = (i / CT) % (m2p / 4), rr = i / (CT * (m2p / 4));
      const float* xr = xs + rr * W * CT + c;
      const float4* pr = reinterpret_cast<const float4*>(e2r) + mq;
      const float4* pi = reinterpret_cast<const float4*>(e2i) + mq;
      float sr[4] = {0.f, 0.f, 0.f, 0.f}, si[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int w = 0; w < W; ++w) {
        const float v = xr[w * CT];
        const float4 er = pr[w * (m2p / 4)], ei = pi[w * (m2p / 4)];
        sr[0] = fmaf(er.x, v, sr[0]); si[0] = fmaf(ei.x, v, si[0]);
        sr[1] = fmaf(er.y, v, sr[1]); si[1] = fmaf(ei.y, v, si[1]);
        sr[2] = fmaf(er.z, v, sr[2]); si[2] = fmaf(ei.z, v, si[2]);
        sr[3] = fmaf(er.w, v, sr[3]); si[3] = fmaf(ei.w, v, si[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = (rr * m2p + 4 * mq + j) * CT + c;
        tr[t] = sr[j];
        ti[t] = si[j];
      }
    }
    __syncthreads();
    // Row DFT, 4 spectrum rows per item, accumulated over the staged rows.
    for (int i = tid; i < n_items; i += kThreads) {
      const int mc = i % (m2 * CT), kq = i / (m2 * CT);
      float sr[4], si[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sr[j] = ar[(4 * kq + j) * m2 * CT + mc];
        si[j] = ai[(4 * kq + j) * m2 * CT + mc];
      }
#pragma unroll 4
      for (int rr = 0; rr < r; ++rr) {
        const float4 er = reinterpret_cast<const float4*>(e1r + (h0 + rr) * Kp)[kq];
        const float4 ei = reinterpret_cast<const float4*>(e1i + (h0 + rr) * Kp)[kq];
        const float e_r[4] = {er.x, er.y, er.z, er.w}, e_i[4] = {ei.x, ei.y, ei.z, ei.w};
        const int t = rr * m2p * CT + mc;  // mc = m * CT + c
        const float vr = tr[t], vi = ti[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sr[j] += e_r[j] * vr - e_i[j] * vi;
          si[j] += e_r[j] * vi + e_i[j] * vr;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ar[(4 * kq + j) * m2 * CT + mc] = sr[j];
        ai[(4 * kq + j) * m2 * CT + mc] = si[j];
      }
    }
  }
  for (int i = tid; i < n_items; i += kThreads) {
    const int mc = i % (m2 * CT), kq = i / (m2 * CT);
    const int c = mc % CT, m = mc / CT;
    if (c >= ct) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * kq + j;
      if (k < K) {
        const size_t o = ((((size_t)b * K + k) * m2 + m) * Ci + c0 + c) * 2;
        xm[o] = ar[k * m2 * CT + mc];
        xm[o + 1] = ai[k * m2 * CT + mc];
      }
    }
  }
}

// Pass 2. ym[b, k, m, o] = sum_i xm[b, k, m, i] * Wc[corner, i, o, kk, m]
// (complex). Rows k < m1 are the first corner (frequencies 0..m1-1),
// rows k >= m1 the second (H-m1..H-1), as in spectral_conv2d_fft.
// weights: (2 corner, 2 re/im, Ci, Co, M1, M2), sliced to [:m1, :m2].
__global__ void __launch_bounds__(kThreads) mode_mix_kernel(
    const float* __restrict__ xm, const float* __restrict__ weights,
    float* __restrict__ ym, int B, int K, int m1, int m2, int Ci, int Co,
    int M1, int M2) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int km = blockIdx.x, k = km / m2, m = km % m2;
  const int corner = k >= m1 ? 1 : 0, kk = k - corner * m1;
  const int b0 = blockIdx.y * kBatchTile, bt = min(kBatchTile, B - b0);
  float* wr = smem;                   // Ci * Co, [i][o]
  float* wi = wr + Ci * Co;           // Ci * Co
  float* xr = wi + Ci * Co;           // kBatchTile * Ci
  float* xi = xr + kBatchTile * Ci;   // kBatchTile * Ci
  const size_t plane = (size_t)Ci * Co * M1 * M2;  // one (corner, re/im)
  const float* wc = weights + corner * 2 * plane + (size_t)kk * M2 + m;
  for (int i = tid; i < Ci * Co; i += kThreads) {
    wr[i] = wc[(size_t)i * M1 * M2];
    wi[i] = wc[plane + (size_t)i * M1 * M2];
  }
  for (int i = tid; i < bt * Ci; i += kThreads) {
    const int bb = i / Ci, c = i % Ci;
    const size_t o = (((size_t)(b0 + bb) * K * m2 + km) * Ci + c) * 2;
    xr[i] = xm[o];
    xi[i] = xm[o + 1];
  }
  __syncthreads();
  for (int i = tid; i < bt * Co; i += kThreads) {
    const int bb = i / Co, o = i % Co;
    float sr = 0.f, si = 0.f;
#pragma unroll 4
    for (int c = 0; c < Ci; ++c) {
      const float a = xr[bb * Ci + c], q = xi[bb * Ci + c];
      const float p = wr[c * Co + o], s = wi[c * Co + o];
      sr += a * p - q * s;
      si += a * s + q * p;
    }
    const size_t y = (((size_t)(b0 + bb) * K * m2 + km) * Co + o) * 2;
    ym[y] = sr;
    ym[y + 1] = si;
  }
}

// Pass 3. z[h, m, o] = sum_k A[h, k] ym[b, k, m, o];
// out[b, h, w, o] = GELU(Re(sum_m B[w, m] z[h, m, o]) + x[b, h, w, :] . w0[o, :] + b0[o])
// ac: (2H, 2K) = [[Ar, -Ai], [Ai, Ar]]; bc: (W, 2*m2) = [Br, -Bi].
// Each output item is a 4 (w) x 4 (o) register tile; the tables it reads
// are padded to whole float4s (Wp = roundup(W, 4), Cop = roundup(Co, 4)).
// Padding lanes are never stored, so they need no initialisation.
__global__ void __launch_bounds__(kThreads) dft_inverse_kernel(
    const float* __restrict__ x, const float* __restrict__ ym,
    const float* __restrict__ ac, const float* __restrict__ bc,
    const float* __restrict__ w0, const float* __restrict__ b0,
    float* __restrict__ out, int H, int W, int Ci, int Co, int K, int m2) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int h0 = blockIdx.y * kRowTile, ht = min(kRowTile, H - h0);
  const int Wp = round4(W), Cop = round4(Co);
  float* a_r = reinterpret_cast<float*>(smem4);  // K * kRowTile, [k][row]
  float* a_i = a_r + K * kRowTile;
  float* b_r = a_i + K * kRowTile;       // m2 * Wp, [m][w]
  float* b_i = b_r + m2 * Wp;
  float* w0t = b_i + m2 * Wp;            // Ci * Cop, [i][o]
  float* bias = w0t + Ci * Cop;          // Cop
  float* z_r = bias + Cop;               // kRowTile * m2 * Cop, [row][m][o]
  float* z_i = z_r + kRowTile * m2 * Cop;
  float* xt = z_i + kRowTile * m2 * Cop; // kRowPair * Ci * Wp, [row][i][w]

  for (int i = tid; i < K * kRowTile; i += kThreads) {
    const int k = i / kRowTile, hh = i % kRowTile;
    const bool in = hh < ht;
    a_r[i] = in ? ac[(size_t)(h0 + hh) * 2 * K + k] : 0.f;
    a_i[i] = in ? ac[(size_t)(H + h0 + hh) * 2 * K + k] : 0.f;
  }
  for (int i = tid; i < m2 * Wp; i += kThreads) {
    const int m = i / Wp, w = i % Wp;
    b_r[i] = w < W ? bc[(size_t)w * 2 * m2 + m] : 0.f;
    b_i[i] = w < W ? -bc[(size_t)w * 2 * m2 + m2 + m] : 0.f;
  }
  for (int i = tid; i < Ci * Cop; i += kThreads) {
    const int c = i / Cop, o = i % Cop;
    w0t[i] = o < Co ? w0[(size_t)o * Ci + c] : 0.f;
  }
  for (int i = tid; i < Cop; i += kThreads) bias[i] = i < Co ? b0[i] : 0.f;
  __syncthreads();

  // Inverse row DFT for the tile's rows; each (m, o) reads ym once.
  static_assert(kRowTile == 8, "the a-table reads below load 8 rows");
  const float* yb = ym + (size_t)b * K * m2 * Co * 2;
  for (int i = tid; i < m2 * Co; i += kThreads) {
    float zr[kRowTile], zi[kRowTile];
#pragma unroll
    for (int hh = 0; hh < kRowTile; ++hh) {
      zr[hh] = 0.f;
      zi[hh] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const size_t y = ((size_t)k * m2 * Co + i) * 2;
      const float yr = yb[y], yi = yb[y + 1];
      const float4* pr = reinterpret_cast<const float4*>(a_r + k * kRowTile);
      const float4* pi = reinterpret_cast<const float4*>(a_i + k * kRowTile);
      const float4 r0 = pr[0], r1 = pr[1], i0 = pi[0], i1 = pi[1];
      const float ar8[kRowTile] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const float ai8[kRowTile] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
      for (int hh = 0; hh < kRowTile; ++hh) {
        zr[hh] += ar8[hh] * yr - ai8[hh] * yi;
        zi[hh] += ar8[hh] * yi + ai8[hh] * yr;
      }
    }
    const int m = i / Co, o = i % Co;
#pragma unroll
    for (int hh = 0; hh < kRowTile; ++hh) {
      z_r[(hh * m2 + m) * Cop + o] = zr[hh];
      z_i[(hh * m2 + m) * Cop + o] = zi[hh];
    }
  }

  const int nwq = Wp / 4, noq = Cop / 4;
  for (int hp = 0; hp < ht; hp += kRowPair) {
    const int nr = min(kRowPair, ht - hp);
    __syncthreads();  // z tile written; previous pair's readers of xt done
    for (int i = tid; i < nr * Ci * W; i += kThreads) {
      const int w = i % W, c = (i / W) % Ci, rr = i / (W * Ci);
      xt[(rr * Ci + c) * Wp + w] = x[(((size_t)b * H + h0 + hp + rr) * W + w) * Ci + c];
    }
    __syncthreads();
    for (int i = tid; i < nr * nwq * noq; i += kThreads) {
      const int oq = i % noq, wq = (i / noq) % nwq, rr = i / (noq * nwq);
      const int hh = hp + rr;
      float spec[4][4] = {}, byp[4][4] = {};
      const float4* zr4 = reinterpret_cast<const float4*>(z_r + hh * m2 * Cop) + oq;
      const float4* zi4 = reinterpret_cast<const float4*>(z_i + hh * m2 * Cop) + oq;
      const float4* br4 = reinterpret_cast<const float4*>(b_r) + wq;
      const float4* bi4 = reinterpret_cast<const float4*>(b_i) + wq;
#pragma unroll 4
      for (int m = 0; m < m2; ++m) {
        const float4 zr = zr4[m * noq], zi = zi4[m * noq];
        const float4 br = br4[m * nwq], bi = bi4[m * nwq];
        const float zra[4] = {zr.x, zr.y, zr.z, zr.w}, zia[4] = {zi.x, zi.y, zi.z, zi.w};
        const float bra[4] = {br.x, br.y, br.z, br.w}, bia[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) spec[u][v] += bra[u] * zra[v] - bia[u] * zia[v];
        }
      }
      const float4* xt4 = reinterpret_cast<const float4*>(xt + rr * Ci * Wp) + wq;
      const float4* w04 = reinterpret_cast<const float4*>(w0t) + oq;
#pragma unroll 4
      for (int c = 0; c < Ci; ++c) {
        const float4 xv = xt4[c * nwq], wv = w04[c * noq];
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w}, wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) byp[u][v] += xa[u] * wa[v];
        }
      }
      float* orow = out + ((size_t)b * H + h0 + hh) * W * Co;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int w = 4 * wq + u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int o = 4 * oq + v;
          if (w < W && o < Co) {
            orow[(size_t)w * Co + o] = gelu_erf(spec[u][v] + (byp[u][v] + bias[o]));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* fno_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (B, H, W, Ci); weights: (2, 2, Ci, Co, M1, M2); w0: (Co, Ci); b0: (Co,)
// e1c, e2c, ac, bc: _dft_factors_packed(H, W, m1, m2); scratch xm: (B, 2*m1,
// m2, Ci, 2) and ym: (B, 2*m1, m2, Co, 2); out: (B, H, W, Co). All float32,
// contiguous, on the current device. Launches on `stream`, does not sync.
int fno_block_forward(const float* x, const float* weights, const float* w0,
                      const float* b0, const float* e1c, const float* e2c,
                      const float* ac, const float* bc, float* xm, float* ym,
                      float* out, int B, int H, int W, int Ci, int Co, int M1,
                      int M2, int m1, int m2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int K = 2 * m1;
  const size_t Kp = round4(K), m2p = round4(m2), Wp = round4(W), Cop = round4(Co);
  const size_t s1 = sizeof(float) *
      (2 * (size_t)H * Kp + 2 * (size_t)W * m2p + (size_t)kRowGroup * W * kChanTile +
       2 * (size_t)kRowGroup * m2p * kChanTile + 2 * Kp * m2 * kChanTile);
  const size_t s2 = sizeof(float) * (2 * (size_t)Ci * Co + 2 * (size_t)kBatchTile * Ci);
  const size_t s3 = sizeof(float) *
      (2 * (size_t)K * kRowTile + 2 * (size_t)m2 * Wp + (size_t)Ci * Cop + Cop +
       2 * (size_t)kRowTile * m2 * Cop + (size_t)kRowPair * Ci * Wp);
  cudaError_t err;
  if ((err = allow_dynamic_smem((const void*)dft_forward_kernel, s1))) return err;
  if ((err = allow_dynamic_smem((const void*)mode_mix_kernel, s2))) return err;
  if ((err = allow_dynamic_smem((const void*)dft_inverse_kernel, s3))) return err;

  dft_forward_kernel<<<dim3(B, (Ci + kChanTile - 1) / kChanTile), kThreads, s1, stream>>>(
      x, e1c, e2c, xm, H, W, Ci, K, m2);
  if ((err = cudaGetLastError())) return err;
  mode_mix_kernel<<<dim3(K * m2, (B + kBatchTile - 1) / kBatchTile), kThreads, s2, stream>>>(
      xm, weights, ym, B, K, m1, m2, Ci, Co, M1, M2);
  if ((err = cudaGetLastError())) return err;
  dft_inverse_kernel<<<dim3(B, (H + kRowTile - 1) / kRowTile), kThreads, s3, stream>>>(
      x, ym, ac, bc, w0, b0, out, H, W, Ci, Co, K, m2);
  return cudaGetLastError();
}

}  // extern "C"
