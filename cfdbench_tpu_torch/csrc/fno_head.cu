// Fused FNO head for Hopper (sm_90a):
//   out = (GELU(x @ w1^T + b1) @ w2^T + b2) * mask
//
// Replaces: cfdbench_tpu/ops/pallas_fno.py::fused_fno_head (body
// `_head_kernel`), the TPU kernel that keeps the (B, H, W, 128) fc1
// intermediate in VMEM.
//
// What bounds it on this card: at the flagship shape (B=128, 64x64,
// C=32, 128 hidden, 2 outputs) it reads x (67 MB) and the mask (2 MB) and
// writes 4 MB, about 22 us at 3.35 TB/s, and does 2.3 G multiply-adds
// plus 67 M erff: about 70 us of FP32 FMA at 67 TFLOP/s before the erff.
// So it is bound by the CUDA cores' arithmetic. The plain PyTorch head
// writes the 268 MB fc1 output, rereads it for GELU, writes it again and
// rereads it for fc2: over 1 GB of traffic.
//
// Design: one thread per pixel, 128 pixels per block. The weights and
// biases sit in shared memory (about 17 KB at C=32); every thread walks
// the hidden units in the same order, so each fc1 row is read as
// broadcast float4 loads, one per 4 input channels. A thread keeps its
// pixel's C inputs in registers (the kernel is instantiated for C <= 32,
// 64 and 128) and its output sums; each hidden activation lives in one
// register, so the intermediate never leaves the SM. The mask multiplies
// at the end. The FNO's 2 outputs are a compile-time count: a count
// checked at run time (up to 8) costs a third of the kernel's time in
// predicated loads and FMAs (measured on an H100 80GB HBM3 at 700 W:
// 0.49 against 0.31 ms at B=128, 64x64, C=32), and two pixels per thread
// did not pay for their registers (0.34 ms).

#include "launch.cuh"

namespace {

constexpr int kHeadThreads = 128;
constexpr int kMaxOut = 8;

// CMAX: largest input width of the instantiation (a multiple of 4).
// NOUT: the output count when it is fixed at compile time (the FNO's 2),
// or 0 for any count up to kMaxOut, checked at run time.
template <int CMAX, int NOUT>
__global__ void __launch_bounds__(kHeadThreads) fno_head_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ mask,
    float* __restrict__ out, long long n, int C, int hidden, int n_out) {
  constexpr int OUTS = NOUT ? NOUT : kMaxOut;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C4 = (C + 3) & ~3;        // w1 row stride: whole float4s
  float* w1s = smem;                  // hidden * C4, [j][c], zero-padded
  float* b1s = w1s + hidden * C4;     // hidden
  float* w2s = b1s + hidden;          // n_out * hidden, [o][j]
  float* b2s = w2s + n_out * hidden;  // n_out
  for (int i = threadIdx.x; i < hidden * C4; i += kHeadThreads) {
    const int j = i / C4, c = i % C4;
    w1s[i] = c < C ? w1[j * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < hidden; i += kHeadThreads) b1s[i] = b1[i];
  for (int i = threadIdx.x; i < n_out * hidden; i += kHeadThreads) w2s[i] = w2[i];
  for (int i = threadIdx.x; i < n_out; i += kHeadThreads) b2s[i] = b2[i];
  __syncthreads();

  const long long p = (long long)blockIdx.x * kHeadThreads + threadIdx.x;
  if (p >= n) return;
  const float* xp = x + p * C;
  float xv[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) xv[c] = c < C ? xp[c] : 0.f;
  float acc[OUTS];
#pragma unroll
  for (int o = 0; o < OUTS; ++o) acc[o] = 0.f;
  for (int j = 0; j < hidden; ++j) {
    const float4* wj = reinterpret_cast<const float4*>(w1s + j * C4);
    float h = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < CMAX / 4; ++c4) {
      if (4 * c4 < C) {
        const float4 w = wj[c4];
        h = fmaf(xv[4 * c4], w.x, h);
        h = fmaf(xv[4 * c4 + 1], w.y, h);
        h = fmaf(xv[4 * c4 + 2], w.z, h);
        h = fmaf(xv[4 * c4 + 3], w.w, h);
      }
    }
    const float g = gelu_erf(h + b1s[j]);
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      if (NOUT || o < n_out) acc[o] = fmaf(g, w2s[o * hidden + j], acc[o]);
    }
  }
  const float mk = mask[p];
  float* op = out + p * n_out;
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    if (NOUT || o < n_out) op[o] = (acc[o] + b2s[o]) * mk;
  }
}

template <int CMAX, int NOUT>
int launch_head(const float* x, const float* w1, const float* b1,
                const float* w2, const float* b2, const float* mask,
                float* out, long long n, int C, int hidden, int n_out,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)hidden * ((C + 3) & ~3) + hidden + (size_t)n_out * hidden + n_out);
  cudaError_t err = allow_dynamic_smem((const void*)fno_head_kernel<CMAX, NOUT>, smem);
  if (err) return err;
  const long long blocks = (n + kHeadThreads - 1) / kHeadThreads;
  fno_head_kernel<CMAX, NOUT><<<(unsigned)blocks, kHeadThreads, smem, stream>>>(
      x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out);
  return cudaGetLastError();
}

template <int CMAX>
int launch_head_outs(const float* x, const float* w1, const float* b1,
                     const float* w2, const float* b2, const float* mask,
                     float* out, long long n, int C, int hidden, int n_out,
                     cudaStream_t stream) {
  if (n_out == 2)
    return launch_head<CMAX, 2>(x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out, stream);
  return launch_head<CMAX, 0>(x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out, stream);
}

}  // namespace

extern "C" {

// x: (n, C) pixels; w1: (hidden, C); b1: (hidden,); w2: (n_out, hidden);
// b2: (n_out,); mask: (n,); out: (n, n_out). All float32, contiguous, on
// the current device; 1 <= C <= 128 and 1 <= n_out <= 8. Launches on
// `stream`, does not sync.
int fno_head_forward(const float* x, const float* w1, const float* b1,
                     const float* w2, const float* b2, const float* mask,
                     float* out, long long n, int C, int hidden, int n_out,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || C < 1 || hidden < 1 || n_out < 1 || n_out > kMaxOut)
    return cudaErrorInvalidValue;
  if (C <= 32) return launch_head_outs<32>(x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out, stream);
  if (C <= 64) return launch_head_outs<64>(x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out, stream);
  if (C <= 128) return launch_head_outs<128>(x, w1, b1, w2, b2, mask, out, n, C, hidden, n_out, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
