#!/usr/bin/env python3
"""Where the port's rollout, or its train step, spends its device time,
on a CUDA card.

Rolls a seeded model out for 20 steps at a batch of 128 on 64x64 under
``torch.profiler``, and prints for each path: the wall time, the summed
device time, the device's idle share of the wall time, and the device
time of each CUDA kernel by name. ``--model fno`` (the default) is the
flagship FNO (depth 4, width 32, 12 modes), through the kernels and
through their plain PyTorch versions; ``--model ffno``, ``unet`` or
``resnet`` is that model at its default widths (one path: it runs no
kernel of ours).
With ``--train`` it profiles 5 float32 train steps at batch 128
(``trainer_auto.train_step``: forward, nmse, backward, Adam) instead,
and also the device time under each autograd node (nested: a node's
time includes the kernels it launched, so the lines overlap).
``--model pixel_diffusion``, ``gencast`` or a latent diffusion model
(default widths; the latent ones on a seeded lite VAE) profiles one 50-step
DDPM frame (the latent ones' with its decode) instead of the rollout, and
with ``--train`` 5 train steps (dropout on; Adam, or GenCast's AdamW
chain), at batch 8, the trainers' default, unless ``--batch`` says
otherwise.

    python3 scripts/profile_torch_rollout.py [--model fno|ffno|unet|resnet|pixel_diffusion|gencast
        |latent_diffusion|latent_diffusion2|latent_diffusion_lite] [--train] [--batch B]
        [--trace DIR]

``--trace DIR`` also writes each path's Chrome trace there.
``--collectives`` (with ``--train``) adds the train step with the
reductions of data parallelism (``parallel/mesh.py``: the loss's SUM and
MAX, the gradient all-reduce) forced through an NCCL group of one rank:
what each step of N > 1 ranks adds on its card, without N cards.
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

from cfdbench_tpu_torch.config import Args  # noqa: E402
from cfdbench_tpu_torch.metrics import loss_name_to_fn  # noqa: E402
from cfdbench_tpu_torch.models import (  # noqa: E402
    LATENT_MODELS,
    init_auto_model,
    init_gencast,
    init_latent_diffusion,
    init_pixel_diffusion,
    make_cfd_vae,
)
from cfdbench_tpu_torch.models.fno import FLAGSHIP, Fno2d, PlainFno2d  # noqa: E402
from cfdbench_tpu_torch.training.optim import make_adam, make_gencast_tx  # noqa: E402
from cfdbench_tpu_torch.training.rollout import make_rollout_fn  # noqa: E402
from cfdbench_tpu_torch.training.trainer_auto import (  # noqa: E402
    AutoTask,
    step_generator,
    train_step,
    use_mesh,
)
from cfdbench_tpu_torch.utils.rng import train_key  # noqa: E402
from cfdbench_tpu_torch.utils.device import require_cuda, set_numerics  # noqa: E402

STEPS = 20
TRAIN_STEPS = 5
BATCH = 128


def profile_path(name, run, trace_dir, autograd_nodes=False):
    run()  # warm-up: kernel build, allocator, cuFFT plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    # Kernels only: a user annotation (Adam's "Optimizer.step") spans
    # kernels that are counted on their own.
    events = [e for e in averages if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.device_time_total for e in events)
    print(f"[{name}] wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / wall_us:.3f}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        print(f"[{name}]   {e.device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.device_time_total / busy_us:6.1%}  {e.key[:90]}")
    if autograd_nodes:
        nodes = [e for e in averages if e.key.startswith("autograd::engine::evaluate_function")]
        for e in sorted(nodes, key=lambda e: -e.device_time_total)[:8]:
            print(f"[{name}]   node {e.device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
                  f"{e.key.split(': ', 1)[-1][:70]}")
        # The host's side: operators by their own CPU time (the profiler
        # adds its cost to each), and how many the run dispatched.
        ops = [e for e in averages if e.device_type == torch.autograd.DeviceType.CPU]
        print(f"[{name}] host: {sum(e.count for e in ops)} operator calls, "
              f"{sum(e.self_cpu_time_total for e in ops) / 1e3:.3f} ms of self CPU time")
        for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]:
            print(f"[{name}]   host {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
                  f"{e.key[:70]}")
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / f"{name}.json"))


def profile_diffusion(opts, device) -> int:
    """One 50-step DDPM frame, or 5 train steps, of pixel diffusion,
    GenCast or a latent diffusion model at their default widths."""
    B = opts.batch or 8
    gen = torch.Generator().manual_seed(1)
    args = Args(model=opts.model)
    init = dict(generator=torch.Generator().manual_seed(0), device=device)
    loss_fn = loss_name_to_fn("nmse")
    if opts.model == "pixel_diffusion":
        task = init_pixel_diffusion(args, 5, loss_fn, **init)
    elif opts.model in LATENT_MODELS:
        vae = make_cfd_vae("lite", generator=torch.Generator().manual_seed(2))
        task = init_latent_diffusion(args, 5, vae.state_dict(), loss_fn, **init)
    else:
        stats = dict(residual_mean=[0.0, 0.0], residual_std=[0.1, 0.1])
        task = init_gencast(args, stats, 5, loss_fn, **init)
    mask = torch.ones((B, 64, 64, 1))
    mask[:, 20:30, 10:40] = 0
    batch = {k: v.to(device) for k, v in dict(
        inputs=torch.randn((B, 64, 64, 2), generator=gen),
        inputs_prev=torch.randn((B, 64, 64, 2), generator=gen),
        labels=torch.randn((B, 64, 64, 2), generator=gen),
        case_params=torch.randn((B, 5), generator=gen), mask=mask,
        weights=torch.ones(B)).items()}
    if not opts.train:
        print(f"{torch.cuda.get_device_name(0)}: {opts.model} 50-step DDPM frame b{B}")
        if opts.model != "gencast":
            def frame():
                task.predict_frame(batch["inputs"], batch["case_params"], batch["mask"])
        else:
            def frame():
                task.generate(batch["inputs"], batch["inputs_prev"], batch["case_params"],
                              batch["mask"])
        profile_path(f"frame_{opts.model}", frame, opts.trace, autograd_nodes=True)
        return 0
    print(f"{torch.cuda.get_device_name(0)}: {opts.model} {TRAIN_STEPS} train steps b{B}")
    if opts.model != "gencast":
        opt, sched = make_adam(task.model.parameters(), 1e-4)
    else:
        opt, sched = make_gencast_tx(task.model.parameters(), 1e-4, total_steps=1000), None
    count = iter(range(10 ** 9))

    def steps():
        for _ in range(TRAIN_STEPS):
            opt.zero_grad(set_to_none=True)
            loss, _ = task.loss_scores(batch, train_key(0, next(count)))
            loss.backward()
            opt.step()
            if sched is not None:
                sched.step()

    profile_path(f"train_{opts.model}", steps, opts.trace, autograd_nodes=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("fno", "ffno", "unet", "resnet", "pixel_diffusion",
                                        "gencast", *LATENT_MODELS), default="fno")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--trace", default="")
    ap.add_argument("--collectives", action="store_true")
    opts = ap.parse_args()
    device = require_cuda()
    set_numerics()
    if opts.model in ("pixel_diffusion", "gencast", *LATENT_MODELS):
        return profile_diffusion(opts, device)
    gen = torch.Generator().manual_seed(1)
    B = opts.batch or BATCH
    init = torch.Generator().manual_seed(0)
    if opts.model == "fno":
        model = Fno2d(n_case_params=5, **FLAGSHIP, generator=init, device=device)
        paths = (("kernel", model), ("plain", PlainFno2d(model)))
    else:
        model = init_auto_model(Args(model=opts.model), n_case_params=5, field_shape=(64, 64),
                                generator=init, device=device)
        paths = ((opts.model, model),)
    include_initial = opts.model == "resnet"  # its rollout's alignment
    # The ResNet's dropout draws in training, from a generator on the card.
    dropout_gen = step_generator(0, 0, device) if opts.model == "resnet" else None
    mask = torch.ones((B, 64, 64, 1))
    mask[:, 20:30, 10:40] = 0
    inputs = (torch.randn((B, 64, 64, 2), generator=gen).to(device),
              torch.randn((B, 5), generator=gen).to(device), mask.to(device))
    if not opts.train:
        print(f"{torch.cuda.get_device_name(0)}: rollout b{B} x {STEPS} steps")
        model.eval()
        for name, fn in paths:
            roll = make_rollout_fn(fn, STEPS, include_initial=include_initial)
            profile_path(f"rollout_{name}", lambda: roll(*inputs), opts.trace)
        return 0
    print(f"{torch.cuda.get_device_name(0)}: {TRAIN_STEPS} train steps b{B}")
    batch = dict(inputs=inputs[0], case_params=inputs[1], mask=inputs[2],
                 labels=torch.randn((B, 64, 64, 2), generator=gen).to(device),
                 weights=torch.ones(B, device=device))
    model.train()
    meshes = {}
    if opts.collectives:
        paths += ((f"{paths[0][0]}_collectives", paths[0][1]),)
        meshes[paths[-1][0]] = collectives_mesh()
    for name, net in paths:
        task = AutoTask(net, loss_name_to_fn("nmse"))
        if name in meshes:
            use_mesh(task, meshes[name])
        opt, sched = make_adam(model.parameters(), 1e-4)

        def steps():
            for _ in range(TRAIN_STEPS):
                train_step(task, opt, sched, batch, dropout_gen)

        profile_path(f"train_{name}", steps, opts.trace, autograd_nodes=True)
    if meshes:
        torch.distributed.destroy_process_group()
    return 0


def collectives_mesh():
    """A data axis of one rank, in an NCCL group of one (an in-process
    store: no file, no port), that runs every collective as N > 1 ranks
    do."""
    import torch.distributed as dist

    from cfdbench_tpu_torch.parallel.mesh import DataMesh

    class Collectives(DataMesh):
        distributed = True

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    return Collectives(1, 0, dist.group.WORLD)


if __name__ == "__main__":
    sys.exit(main())
