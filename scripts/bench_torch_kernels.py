#!/usr/bin/env python3
"""Time the port's CUDA kernels on a card, pass by pass.

Builds ``cfdbench_tpu_torch/csrc`` and times each kernel of the FnoBlock
(its four passes) and the head at the flagship shape (B=128, 64x64, 32
channels, 12 modes, 128 hidden units, 2 outputs) with ``torch.profiler``
over 20 calls, on inputs drawn from N(0, 1), after checking both against
their plain PyTorch versions. Then it measures the card's
``mma.sync.m16n8k8`` TF32 rate with a kernel that issues nothing else.

    python3 scripts/bench_torch_kernels.py

Needs a CUDA card and ``nvcc``; writes the rate probe under
``build/bench_torch_kernels/``.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from cfdbench_tpu_torch.ops import _build  # noqa: E402
from cfdbench_tpu_torch.ops import fno_kernels as fk  # noqa: E402
from cfdbench_tpu_torch.utils.device import require_cuda, set_f32_numerics  # noqa: E402

OUT = REPO_ROOT / "build" / "bench_torch_kernels"
B, H, W, C, MODES, HIDDEN, N_OUT = 128, 64, 64, 32, 12, 128, 2
MMA_RATE = r'''
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
__global__ void rate(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b[2] = {threadIdx.x * 5u, 11u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == 1.2345f) out[0] = s;
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, 4);
  const int blocks = 4 * sms, threads = 256, iters = 4096;
  rate<<<blocks, threads>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2048.0 * blocks * (threads / 32) * iters * 8;
  printf("mma.sync.m16n8k8 tf32: %.1f TFLOP/s (%d blocks of 8 warps, 8 independent "
         "accumulators each)\n", flop / ms / 1e9, blocks);
  return cudaGetLastError();
}
'''


def kernel_ms(fn) -> dict:
    """Device time per call of every kernel ``fn`` launches, over 20 calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)", e.key)
        if m and e.device_time_total > 0:
            times[m.group(1)] = e.device_time_total / 20 / 1e3
    return times


def main() -> int:
    device = require_cuda()
    set_f32_numerics()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    OUT.mkdir(parents=True, exist_ok=True)
    lib = _build.load_library()

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((B, H, W, C), generator=gen).to(device)
    w = (torch.rand((2, 2, C, C, MODES, MODES), generator=gen) / C).to(device)
    w0 = (torch.randn((C, C), generator=gen) / C ** 0.5).to(device)
    b0 = (torch.randn(C, generator=gen) * 0.1).to(device)
    w1 = (torch.randn((HIDDEN, C), generator=gen) / C ** 0.5).to(device)
    b1 = (torch.randn(HIDDEN, generator=gen) * 0.1).to(device)
    w2 = (torch.randn((N_OUT, HIDDEN), generator=gen) / HIDDEN ** 0.5).to(device)
    b2 = (torch.randn(N_OUT, generator=gen) * 0.1).to(device)
    mask = torch.ones((B, H, W, 1), device=device)
    block = (x, w, w0, b0, MODES, MODES)
    head = (x, w1, b1, w2, b2, mask)
    want_block, want_head = fk.fno_block_reference(*block), fk.fno_head_reference(*head)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"[{card}] B={B} {H}x{W} C={C} modes={MODES}, inputs N(0, 1); ms per call")
    with torch.inference_mode():
        err_block = (fk._block_call(lib, *block, stream)[0] - want_block).abs().max().item()
        err_head = (fk._head_call(lib, *head, stream) - want_head).abs().max().item()
        times = kernel_ms(lambda: fk._block_call(lib, *block, stream))
        times.update(kernel_ms(lambda: fk._head_call(lib, *head, stream)))
    block_ms = sum(v for k, v in times.items() if not k.startswith("fno_head"))
    print(f"err block {err_block:.3e} head {err_head:.3e}; block {block_ms:.4f} = "
          + " + ".join(f"{k} {v:.4f}" for k, v in times.items() if not k.startswith("fno_head"))
          + f"; head {times['fno_head_kernel']:.4f}")

    src = OUT / "mma_rate.cu"
    src.write_text(MMA_RATE)
    exe = OUT / "mma_rate"
    subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True)
    print(f"[{card}] " + subprocess.run([str(exe)], capture_output=True, text=True,
                                        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
