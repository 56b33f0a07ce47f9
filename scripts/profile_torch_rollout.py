#!/usr/bin/env python3
"""Where the port's FNO rollout spends its device time, on a CUDA card.

Rolls a seeded flagship FNO (depth 4, width 32, 12 modes, 64x64) out
for 20 steps at a batch of 128 — through the kernels, and through their
plain PyTorch versions — under ``torch.profiler``, and prints for each
path: the wall time, the summed device time, the device's idle share of
the wall time, and the device time of each CUDA kernel by name.

    python3 scripts/profile_torch_rollout.py [--trace DIR]

``--trace DIR`` also writes each path's Chrome trace there.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from cfdbench_tpu_torch.models.fno import FLAGSHIP, Fno2d, fno2d_reference  # noqa: E402
from cfdbench_tpu_torch.training.rollout import make_rollout_fn  # noqa: E402
from cfdbench_tpu_torch.utils.device import require_cuda, set_f32_numerics  # noqa: E402

STEPS = 20
BATCH = 128


def profile_path(name, roll, inputs, trace_dir):
    roll(*inputs)  # warm-up: kernel build, allocator, cuFFT plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        roll(*inputs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    print(f"[{name}] wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / wall_us:.3f}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        print(f"[{name}]   {e.device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.device_time_total / busy_us:6.1%}  {e.key[:90]}")
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / f"rollout_{name}.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="")
    opts = ap.parse_args()
    device = require_cuda()
    set_f32_numerics()
    gen = torch.Generator().manual_seed(1)
    B = BATCH
    model = Fno2d(n_case_params=5, **FLAGSHIP, generator=torch.Generator().manual_seed(0),
                  device=device).eval()
    mask = torch.ones((B, 64, 64, 1))
    mask[:, 20:30, 10:40] = 0
    inputs = (torch.randn((B, 64, 64, 2), generator=gen).to(device),
              torch.randn((B, 5), generator=gen).to(device), mask.to(device))
    print(f"{torch.cuda.get_device_name(0)}: rollout b{B} x {STEPS} steps")
    profile_path("kernel", make_rollout_fn(model, STEPS), inputs, opts.trace)
    plain = make_rollout_fn(lambda f, c, m: fno2d_reference(model, f, c, m), STEPS)
    profile_path("plain", plain, inputs, opts.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
