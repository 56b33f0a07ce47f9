#!/usr/bin/env python3
"""Time the port's CUDA kernels on a card, pass by pass.

Builds ``cfdbench_tpu_torch/csrc``, counts the Hopper instructions in the
library's SASS (``HGMMA``, ``UTMALDG``, ``UBLKCP``: ``cuobjdump -sass``),
and times each kernel of the FnoBlock (its passes, on the route its shape
takes: ``fno_block_route``) and of the head (on its route:
``fno_head_route``) at the flagship shape (B=128, 64x64, 32 channels, 12
modes, 128 hidden units, 2 outputs) with ``torch.profiler`` over 20 calls,
on inputs drawn from N(0, 1), after checking both against their plain
PyTorch versions, in each mode that ``--matmul_precision`` names (default:
both): split TF32 (``highest``, ``default``, ...) and the one-product TF32
mode (``high``, ``tensorfloat32``, ``TF32_TF32_F32``), the latter against
the plain version of its mode and beside its distance from the float32
one. Each kernel's old route (route 0: ``mma.sync`` and ``cp.async``) runs
beside its new one at the same shape: its kernels by the profiler, and
both whole calls by CUDA events in the same turns (old, new, new, old).

The head's epilogue's SASS instructions per hidden unit come from a probe
that compiles the kernel's epilogue alone (``hopper_epilogue`` on 64
accumulators a thread, less a probe that only adds them up, whose one add a
unit is counted back), and give the epilogue's floor on the CUDA cores:
instructions x n x hidden / (132 SMs x 128 lanes x the SM clock
``nvidia-smi`` reports as its maximum). At the flagship and at a rank's 16 of 64 rows it also sets the
head's device time on each route beside the host's time to enqueue one
call, through the registered operator (``fno_head``, as the models call
it) and through ``_head_call`` alone. Then it measures the card's
``mma.sync.m16n8k8`` TF32 rate with a kernel that issues nothing else.

    python3 scripts/bench_torch_kernels.py [--matmul_precision highest high]

Needs a CUDA card and ``nvcc``; writes the rate probe under
``build/bench_torch_kernels/``.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from cfdbench_tpu_torch.ops import _build  # noqa: E402
from cfdbench_tpu_torch.ops import fno_kernels as fk  # noqa: E402
from cfdbench_tpu_torch.utils.device import require_cuda, set_numerics, uses_tf32  # noqa: E402

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


# The head's epilogue alone: 64 accumulators a thread through hopper_epilogue
# (b1 and w2 in shared memory, as in the kernel), or only summed (the
# probe's own loads and stores, subtracted).
EPILOGUE_PROBE = r'''
#include "fno_head.cu"
template <bool EPILOGUE>
__device__ void probe(const float* acc_in, const float* b1, const float* w2, float* out) {
  __shared__ float b1s[kHopN], w2s[2 * kHopN];
  for (int i = threadIdx.x; i < kHopN; i += blockDim.x) b1s[i] = b1[i];
  for (int i = threadIdx.x; i < 2 * kHopN; i += blockDim.x) w2s[i] = w2[i];
  __syncthreads();
  float acc[kHopN / 2], s[2][2] = {};
  for (int i = 0; i < kHopN / 2; ++i) acc[i] = acc_in[threadIdx.x * (kHopN / 2) + i];
  if (EPILOGUE) {
    hopper_epilogue<2, true>(acc, s, b1s, w2s, kHopN, kHopN / 32, threadIdx.x & 3);
  } else {
#pragma unroll
    for (int i = 0; i < kHopN / 2; ++i) s[i & 1][(i >> 1) & 1] += acc[i];
  }
  for (int i = 0; i < 4; ++i) out[threadIdx.x * 4 + i] = s[i >> 1][i & 1];
}
extern "C" __global__ void probe_epilogue(const float* a, const float* b, const float* w, float* o) {
  probe<true>(a, b, w, o);
}
extern "C" __global__ void probe_sum(const float* a, const float* b, const float* w, float* o) {
  probe<false>(a, b, w, o);
}
'''


def sass_functions(binary: Path) -> dict:
    """Each function's SASS instructions in a cubin or library."""
    sass = subprocess.run([str(Path(_build.find_nvcc()).with_name("cuobjdump")), "-sass",
                           str(binary)], capture_output=True, text=True, check=True).stdout
    return {f.split("\n", 1)[0].strip(): re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", f)
            for f in re.split(r"\n\s*Function : ", sass)[1:]}


def epilogue_instructions() -> float:
    """SASS instructions a hidden unit of the head's epilogue (EPILOGUE_PROBE)."""
    src = OUT / "epilogue_probe.cu"
    src.write_text(EPILOGUE_PROBE)
    cubin = OUT / "epilogue_probe.cubin"
    subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-cubin", "-I", str(_build.CSRC), "-o", str(cubin), str(src)],
                   check=True)
    fns = sass_functions(cubin)
    return (len(fns["probe_epilogue"]) - len(fns["probe_sum"])) / 64 + 1


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


def call_ms(fn, calls: int = 20) -> float:
    """Mean ms a call of ``fn`` by CUDA events over ``calls`` calls after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def enqueue_ms(fn, calls: int = 200) -> float:
    """Host ms to enqueue a call of ``fn``, over ``calls`` calls after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def head_host(lib, card: str, device) -> None:
    """The head at the flagship and at 16 of 64 rows (B=128): device ms a
    call on each route, and the host's ms to enqueue one through the
    registered operator and through ``_head_call``."""
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(1)
    for rows in (H, 16):
        head = tuple(t.to(device) for t in (
            torch.randn((B, rows, W, C), generator=gen), torch.randn((HIDDEN, C), generator=gen),
            torch.randn(HIDDEN, generator=gen), torch.randn((N_OUT, HIDDEN), generator=gen),
            torch.randn(N_OUT, generator=gen), torch.ones((B, rows, W, 1))))
        with torch.inference_mode():
            dev_ms = {r: sum(kernel_ms(lambda r=r: fk._head_call(lib, *head, stream,
                                                                 route=r)).values())
                      for r in (0, None)}
            host = (enqueue_ms(lambda: fk.fno_head(*head)),
                    enqueue_ms(lambda: fk._head_call(lib, *head, stream)))
        print(f"[{card}] fno_head B={B} {rows}x{W}: device {dev_ms[None]:.4f} ms a call "
              f"(route 0: {dev_ms[0]:.4f}); the host enqueues a call in {host[0]:.4f} ms "
              f"through the registered operator, {host[1]:.4f} ms through _head_call")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--matmul_precision", nargs="+", default=["highest", "high"],
                        help="the modes to time, by --matmul_precision value")
    modes = [uses_tf32(v) for v in parser.parse_args(argv).matmul_precision]
    device = require_cuda()
    set_numerics()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    OUT.mkdir(parents=True, exist_ok=True)
    lib = _build.load_library()
    sass = subprocess.run([str(Path(_build.find_nvcc()).with_name("cuobjdump")), "-sass",
                           str(_build.LIBRARY)], capture_output=True, text=True, check=True).stdout
    ops = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "UBLKCP")}
    print(f"[{card}] kernel library SASS: " + ", ".join(f"{op} {n}" for op, n in ops.items()))
    route = fk.block_route(lib, H, W, C, C, MODES, MODES)
    print(f"[{card}] fno_block at the flagship: {fk.route_name(route)}")
    head_route = fk.head_route(lib, C, HIDDEN, N_OUT)
    head_kernels = fk.head_route_kernels(head_route)
    print(f"[{card}] fno_head at the flagship: {fk.head_route_name(head_route)}")
    count = epilogue_instructions()
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, check=True).stdout.split()[0])
    floor = count * B * H * W * HIDDEN / (132 * 128 * clock * 1e6) * 1e3
    print(f"[{card}] fno_head epilogue: {count:.2f} SASS instructions a hidden unit, floor "
          f"{floor:.4f} ms at {clock:.0f} MHz (132 SMs x 128 lanes)")

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
    f32_block, f32_head = fk.fno_block_reference(*block), fk.fno_head_reference(*head)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"[{card}] B={B} {H}x{W} C={C} modes={MODES}, inputs N(0, 1); ms per call")
    for tf32 in modes:
        want_block = fk.fno_block_reference(*block, tf32=tf32)
        want_head = fk.fno_head_reference(*head, tf32=tf32)
        with torch.inference_mode():
            got_block = fk._block_call(lib, *block, stream, tf32=tf32)[0]
            got_head = fk._head_call(lib, *head, stream, tf32)
            err_block = (got_block - want_block).abs().max().item()
            err_head = (got_head - want_head).abs().max().item()
            f32_err = ((got_block - f32_block).abs().max().item(),
                       (got_head - f32_head).abs().max().item())
            times = kernel_ms(lambda: fk._block_call(lib, *block, stream, tf32=tf32))
            times.update(kernel_ms(lambda: fk._head_call(lib, *head, stream, tf32)))
            old = kernel_ms(lambda: fk._block_call(lib, *block, stream, tf32=tf32, route=0))
            turns = [call_ms(lambda r=r: fk._block_call(lib, *block, stream, tf32=tf32, route=r))
                     for r in (0, route, route, 0)]
            head_old = kernel_ms(lambda: fk._head_call(lib, *head, stream, tf32, route=0))
            head_turns = [call_ms(lambda r=r: fk._head_call(lib, *head, stream, tf32, route=r))
                          for r in (0, head_route, head_route, 0)]
        block_ms = sum(v for k, v in times.items() if not k.startswith("fno_head"))
        mode = 'TF32' if tf32 else 'split TF32'
        print(f"[{card}] {mode}: err against the plain version of "
              f"the mode: block {err_block:.3e} (of max {want_block.abs().max().item():.3f}), "
              f"head {err_head:.3e}; against the float32 plain version: block {f32_err[0]:.3e}, "
              f"head {f32_err[1]:.3e}; block {block_ms:.4f} = "
              + " + ".join(f"{k} {v:.4f}" for k, v in times.items()
                           if not k.startswith("fno_head"))
              + "; head " + " + ".join(f"{k} {times[k]:.4f}" for k in head_kernels))
        print(f"[{card}] {mode}: block on route 0, {sum(old.values()):.4f} = "
              + " + ".join(f"{k} {v:.4f}" for k, v in old.items())
              + f"; whole calls by CUDA events, routes (0, {route}, {route}, 0): "
              + ", ".join(f"{v:.4f}" for v in turns) + " ms")
        print(f"[{card}] {mode}: head on route 0, " + " + ".join(
                  f"{k} {v:.4f}" for k, v in head_old.items())
              + f"; whole calls by CUDA events, routes (0, {head_route}, {head_route}, 0): "
              + ", ".join(f"{v:.4f}" for v in head_turns) + " ms")

    head_host(lib, card, device)
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
