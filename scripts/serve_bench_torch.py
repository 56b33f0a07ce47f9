#!/usr/bin/env python
"""Serving-latency benchmark of the port's exported artifacts (port of
``scripts/serve_bench.py``).

Times what a serving process sees: the per-call latency and throughput
of a loaded ``.pt2`` artifact, its input shapes read from the artifact.
``--selftest`` builds a seeded throwaway model (``--model fno``, the
flagship's kernels, or ``unet``, whose BatchNorm running statistics ride
along as buffers, or at its default widths ``pixel_diffusion`` or
``latent_diffusion2`` on a seeded lite VAE, ``--inference_steps``
denoising steps), exports its predict and rollout programs, and times
each served program against the same computation run in process
(``task.predict_frame``, ``training/rollout.py::make_rollout_fn``, the
diffusion models' stochastic); it also reports the FNO kernels' launches
in one served call, and the served output's largest difference from the
in-process one. A diffusion model's served call is timed on noise drawn
before it (``ServedProgram.draw_noise``), whose time is reported apart
(``noise_draw_ms``), beside the graph's nodes and its loop operators by
depth; served without noise it is held to the in-process call, which
draws its own.

Each call's latency is host wall time that ends in
``torch.cuda.synchronize()``, what a server sees; the CUDA-event time of
the same calls stands beside it (``device_ms_per_call``). Prints one
JSON dict.

Usage, on the card:
    python scripts/serve_bench_torch.py --artifact <run>/serve/rollout.pt2
    python scripts/serve_bench_torch.py --selftest --model fno --batch 128 --grid 64
    python scripts/serve_bench_torch.py --selftest --model pixel_diffusion --batch 8
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import torch  # noqa: E402

N_CASE_PARAMS = 5
DIFFUSION = ("pixel_diffusion", "latent_diffusion2")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, args, iters: int, device: torch.device, warmup: bool = True):
    """After one warm-up call (unless told not to): the median host wall
    ms of a call that ends in a synchronize, and on the card the mean
    CUDA-event ms of the same calls (None on the CPU); and the last call's
    output."""
    if warmup:
        fn(*args)
        _sync(device)
    cuda = device.type == "cuda"
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)] if cuda else []
    wall = []
    for i in range(iters):
        t0 = time.perf_counter()
        if cuda:
            events[i][0].record()
        out = fn(*args)
        if cuda:
            events[i][1].record()
        _sync(device)
        wall.append(time.perf_counter() - t0)
    device_ms = statistics.fmean(a.elapsed_time(b) for a, b in events) if cuda else None
    return dict(latency_ms_per_call=1e3 * statistics.median(wall),
                device_ms_per_call=device_ms), out


def served_times(path: Path, served, args, iters: int, warmup: bool = True):
    """Time the loaded artifact ``served`` on ``args``: its record and the
    last call's output."""
    times, out = time_calls(served, args, iters, served.device, warmup)
    # predict artifacts return (B, H, W, C); rollout ones (S, B, H, W, C)
    steps, batch = (out.shape[0], out.shape[1]) if out.dim() == 5 else (1, out.shape[0])
    return dict(artifact=str(path), device=str(served.device),
                bytes=Path(path).stat().st_size, in_shapes=served.input_shapes,
                out_shape=tuple(out.shape), **times,
                frames_per_sec=steps * batch / times["latency_ms_per_call"] * 1e3), out


def bench_artifact(path: Path, iters: int, served=None) -> dict:
    """Time one artifact (``served``, when the caller has loaded it) on
    ones of its input shapes."""
    from cfdbench_tpu_torch.utils.export import load_exported

    served = load_exported(path) if served is None else served
    args = [torch.ones(s, device=served.device) for s in served.input_shapes]
    with torch.inference_mode():
        return served_times(path, served, args, iters)[0]


def selftest_task(ns, device: torch.device):
    """The throwaway task: the FNO at ``--depth``, ``--hidden``,
    ``--modes``, the U-Net with ``--hidden`` base channels, or a
    diffusion model at its default widths."""
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.models import (
        Fno2d, UNet, init_latent_diffusion, init_pixel_diffusion, make_cfd_vae,
    )
    from cfdbench_tpu_torch.training.trainer_auto import AutoTask

    gen = torch.Generator().manual_seed(0)
    if ns.model in DIFFUSION:
        args = Args(model=ns.model)
        if ns.model == "pixel_diffusion":
            task = init_pixel_diffusion(args, N_CASE_PARAMS, generator=gen, device=device)
        else:
            vae = make_cfd_vae("lite", generator=torch.Generator().manual_seed(5), device=device)
            task = init_latent_diffusion(args, N_CASE_PARAMS, vae.state_dict(), generator=gen,
                                         device=device)
        task.num_inference_steps = ns.inference_steps
        return task
    if ns.model == "fno":
        model = Fno2d(in_chan=2, out_chan=2, n_case_params=N_CASE_PARAMS, num_layers=ns.depth,
                      modes1=ns.modes, modes2=ns.modes, hidden_dim=ns.hidden, generator=gen,
                      device=device)
    else:
        model = UNet(in_chan=2, out_chan=2, n_case_params=N_CASE_PARAMS,
                     insert_case_params_at="input", dim=ns.hidden, generator=gen, device=device)
    return AutoTask(model)


def selftest(ns, device: torch.device) -> dict:
    """Export the throwaway model and time served against in process."""
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts
    from cfdbench_tpu_torch.training.rollout import make_rollout_fn
    from cfdbench_tpu_torch.utils.export import (
        export_predict, export_rollout, graph_stats, load_exported,
    )

    task = selftest_task(ns, device)
    task.model.eval()
    sampler = ns.model in DIFFUSION
    B, H, W = ns.batch, ns.grid, ns.grid
    gen = torch.Generator().manual_seed(1)
    inputs = (torch.randn((B, H, W, 2), generator=gen).to(device),
              torch.randn((B, N_CASE_PARAMS), generator=gen).to(device),
              torch.ones((B, H, W, 1), device=device))
    config = (dict(model=ns.model, batch=B, grid=ns.grid, inference_steps=ns.inference_steps,
                   steps=ns.steps) if sampler else
              dict(model=ns.model, batch=B, grid=ns.grid, hidden=ns.hidden, depth=ns.depth,
                   modes=ns.modes, steps=ns.steps))
    out = dict(config=config, device=str(device))
    sections = (
        ("predict", lambda p: export_predict(task, p, B, H, W, N_CASE_PARAMS, device=device),
         task.predict_frame),
        ("rollout", lambda p: export_rollout(task, p, B, H, W, N_CASE_PARAMS, steps=ns.steps,
                                             device=device),
         make_rollout_fn(task.predict_frame, ns.steps, stochastic=sampler)),
    )
    with tempfile.TemporaryDirectory() as td:
        for kind, export, live in sections:
            if ns.only and kind != ns.only:
                continue
            path = Path(td) / f"{kind}.pt2"
            t0 = time.perf_counter()
            export(path)
            export_s = time.perf_counter() - t0
            program = load_exported(path)
            with torch.inference_mode():
                if sampler:
                    # Timed on the noise that a call without it draws (the
                    # in-process call's), the draw timed apart; the last
                    # call's frames are held to the in-process ones.
                    draw, noise = time_calls(program.draw_noise, (), ns.iters, device,
                                             ns.warmup)
                    reset_launch_counts()
                    served, got = served_times(path, program, (*inputs, noise), ns.iters,
                                               ns.warmup)
                    calls = ns.iters + ns.warmup
                    launches = {k: n // calls for k, n in launch_counts().items()}
                    live_times, want = time_calls(live, inputs, ns.iters, device, ns.warmup)
                    served.update(noise_draw_ms=draw["latency_ms_per_call"],
                                  noise_draw_device_ms=draw["device_ms_per_call"],
                                  **graph_stats(program.program),
                                  weights_bytes=sum(t.numel() * t.element_size()
                                                    for t in program.program.state_dict.values()))
                else:
                    served = bench_artifact(path, ns.iters, program)
                    reset_launch_counts()
                    got = program(*inputs)
                    _sync(device)
                    launches = launch_counts()
                    want = live(*inputs)
                    live_times = time_calls(live, inputs, ns.iters, device)[0]
            served.pop("artifact")
            served.update(
                export_s=export_s, launches_per_call=launches,
                max_abs_diff_vs_in_process=(got - want).abs().max().item(),
                max_abs_out=want.abs().max().item(),
                in_process_ms_per_call=live_times["latency_ms_per_call"],
                in_process_device_ms_per_call=live_times["device_ms_per_call"],
                served_overhead_pct=100.0 * (served["latency_ms_per_call"]
                                             / live_times["latency_ms_per_call"] - 1.0))
            out[kind] = served
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifact", type=Path, default=None, help="a .pt2 artifact to time")
    ap.add_argument("--selftest", action="store_true",
                    help="export a throwaway model (--model) and compare served with in "
                         "process")
    ap.add_argument("--model", choices=["fno", "unet", *DIFFUSION], default="fno",
                    help="selftest model")
    ap.add_argument("--inference_steps", type=int, default=50,
                    help="selftest: a diffusion model's denoising steps")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--warmup", type=int, choices=[0, 1], default=1,
                    help="selftest of a diffusion model: 0 times its first calls, with no "
                         "warm-up call")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--modes", type=int, default=12)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--only", choices=["predict", "rollout"], default=None,
                    help="selftest: run just one section")
    ap.add_argument("--device", default=None,
                    help="selftest device (default: the CUDA card; cpu for tests)")
    ns = ap.parse_args(argv)
    if ns.artifact is None and not ns.selftest:
        ap.error("pass --artifact PATH and/or --selftest")

    from cfdbench_tpu_torch.utils.device import require_cuda, set_numerics

    set_numerics()
    result = {}
    if ns.artifact is not None:
        result["artifact_bench"] = bench_artifact(ns.artifact, ns.iters)
    if ns.selftest:
        device = require_cuda() if ns.device is None else torch.device(ns.device)
        if device.type == "cuda":
            result["card"] = torch.cuda.get_device_name(device)
        result["selftest"] = selftest(ns, device)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
