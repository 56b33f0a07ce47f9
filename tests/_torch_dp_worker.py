"""One rank of a data-parallel run of the port, spawned by
``tests/test_torch_parallel.py`` (and importable without JAX, so that the
spawned processes stay light).

:func:`run` joins a gloo group through a file under the test's temporary
directory (never a TCP port: several test workers run at once), runs the
job that the test saved beside it, and saves this rank's results.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


def host_step(case: dict, mesh):
    """One ``trainer_auto.train_step`` of ``case`` on ``mesh``'s block of its
    global batch; returns what the test compares: the loss dict, the
    parameters and gradients after the step, the buffers (BatchNorm's
    running statistics), and the train forward's output gathered over the
    ranks."""
    from cfdbench_tpu_torch.models import diffusion
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.trainer_auto import train_step, use_mesh

    task = build_task(case)
    use_mesh(task, mesh)
    draws = case.get("draws")

    def fixed(key, shape, T, device):  # the global draws the test made
        assert tuple(shape) == tuple(draws["noise"].shape), (shape, draws["noise"].shape)
        return torch.from_numpy(draws["noise"]), torch.from_numpy(draws["t"])

    def masks(key, shapes, rate, device):
        assert [tuple(s) for s in shapes] == [m.shape for m in draws["masks"]]
        return [torch.from_numpy(m) for m in draws["masks"]]

    originals = diffusion.train_noise_and_t, diffusion.dropout_keep_masks
    if draws is not None:
        diffusion.train_noise_and_t, diffusion.dropout_keep_masks = fixed, masks
    outputs = []
    net = getattr(task.model, "unet", task.model)  # a latent model's noise predictor
    hook = net.register_forward_hook(lambda m, i, o: outputs.append(o.detach()))
    opt, sched = make_adam(task.model.parameters(), case["lr"], steps_per_epoch=10)
    dtype = case.get("dtype", torch.float32)
    batch = {k: torch.from_numpy(v).to(dtype) for k, v in mesh.block(case["batch"]).items()}
    step_draws = case["key"] if "key" in case else task.step_draws(0, 0, "cpu")
    try:
        scores = train_step(task, opt, sched, batch, step_draws)
    finally:
        hook.remove()
        diffusion.train_noise_and_t, diffusion.dropout_keep_masks = originals
    return dict(scores={k: float(v) for k, v in scores.items()},
                params={k: p.detach().clone() for k, p in task.model.named_parameters()},
                grads={k: p.grad.clone() for k, p in task.model.named_parameters()},
                buffers={k: b.clone() for k, b in task.model.named_buffers()},
                output=mesh.gather(outputs[0].float()))


def host_sample(case: dict, mesh):
    """A diffusion task's frames on ``mesh``'s block of its global batch, as
    ``main_multistep`` generates them (the sampler's draws over the global
    batch), gathered over the ranks."""
    from cfdbench_tpu_torch.training.trainer_auto import use_mesh

    task = build_task(case)
    use_mesh(task, mesh)
    task.model.eval()
    task.num_inference_steps = case["inference_steps"]
    b = {k: torch.from_numpy(v) for k, v in mesh.block(case["batch"]).items()}
    if case["model"] == "gencast":
        out = task.generate(b["inputs"], b["inputs_prev"], b["case_params"], b["mask"])
    else:
        out = task.predict_frame(b["inputs"], b["case_params"], b["mask"])
    return mesh.gather(out.float())


def build_task(case: dict):
    """The case's task, its weights from ``case["state"]``."""
    from cfdbench_tpu_torch.metrics import loss_name_to_fn

    task = make_task(case["model"], case["widths"], loss_name_to_fn("nmse"),
                     case.get("compute_dtype"))
    task.model.load_state_dict(case["state"])
    if "dtype" in case:
        task.model.to(case["dtype"])
        if hasattr(task, "vae"):
            task.vae.to(case["dtype"])
    return task


def make_task(model: str, widths: dict, loss_fn=None, compute_dtype=None):
    """A task of ``model`` at ``widths``, initialised from fixed seeds."""
    from cfdbench_tpu_torch.models import diffusion, make_cfd_vae
    from cfdbench_tpu_torch.models.fno import Fno2d
    from cfdbench_tpu_torch.models.resnet import ResNet
    from cfdbench_tpu_torch.models.unet import UNet
    from cfdbench_tpu_torch.training.trainer_auto import AutoTask

    gen = torch.Generator().manual_seed(0)
    if model == "pixel":
        return diffusion.PixelDiffusionCfdModel(loss_fn, 2, 5, generator=gen, **widths)
    if model == "gencast":
        return diffusion.GenCastCfdModel(loss_fn, np.array(GENCAST_STATS[0], np.float32),
                                         np.array(GENCAST_STATS[1], np.float32),
                                         generator=gen, **widths)
    if model == "latent":
        vae = make_cfd_vae("lite", generator=torch.Generator().manual_seed(5))
        return diffusion.LatentDiffusionCfdModel2(loss_fn, vae, generator=gen, **widths)
    cls = {"fno": Fno2d, "unet": UNet, "resnet": ResNet}[model]
    return AutoTask(cls(in_chan=2, out_chan=2, n_case_params=5, generator=gen, **widths),
                    loss_fn, compute_dtype=compute_dtype)


# GenCast's residual mean and standard deviation, per channel.
GENCAST_STATS = ((0.1, -0.2), (0.5, 2.0))


def run_cli(calls, init_state):
    """``(entry, argv)`` calls of the port's CLI on the CPU, in order; the
    autoregressive model starts from ``init_state`` when given (the JAX
    trainer's initial weights). Returns main_multistep's frames."""
    from cfdbench_tpu_torch import cli
    from cfdbench_tpu_torch.models import init_auto_model

    if init_state is not None:
        def init_from(*args, **kwargs):
            model = init_auto_model(*args, **kwargs)
            model.load_state_dict(init_state)
            return model

        cli.init_auto_model = init_from
    frames = []
    for entry, argv in calls:
        out = getattr(cli, entry)(argv, device="cpu")
        if entry == "main_multistep":
            frames.append(out)
    return dict(frames=frames)


def run(rank: int, world: int, root: str) -> None:
    """Rank ``rank`` of ``world``: the job in ``root/job.pt``, its results
    to ``root/rank{rank}.pt``."""
    from cfdbench_tpu_torch.parallel.mesh import make_mesh

    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root / 'rendezvous'}",
                            rank=rank, world_size=world)
    try:
        job = torch.load(root / "job.pt", weights_only=False)
        mesh = make_mesh(str(world), dist.group.WORLD)
        if job["kind"] == "steps":
            result = {name: host_step(case, mesh) for name, case in job["cases"].items()}
            result["samples"] = {name: host_sample(case, mesh)
                                 for name, case in job["samples"].items()}
        else:
            result = run_cli(job["calls"], job.get("init_state"))
        torch.save(result, root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(job: dict, root: Path, world: int = 2):
    """Run ``job`` on ``world`` spawned ranks; returns each rank's results."""
    import torch.multiprocessing as mp

    root.mkdir(parents=True, exist_ok=True)
    torch.save(job, root / "job.pt")
    mp.spawn(run, args=(world, str(root)), nprocs=world, join=True)
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]


def global_batch(rng: np.random.Generator, B: int, H: int = 16, W: int = 16,
                 valid: int = None) -> dict:
    """A seeded global batch of ``B`` rows, the last ``B - valid`` of them
    zero padding with weight 0, as ``data/pipeline.py`` pads."""
    valid = B if valid is None else valid
    mask = (rng.uniform(size=(B, H, W, 1)) > 0.2).astype(np.float32)
    batch = dict(inputs=rng.standard_normal((B, H, W, 2)),
                 labels=rng.standard_normal((B, H, W, 2)),
                 mask=mask, case_params=rng.standard_normal((B, 5)))
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    for v in batch.values():
        v[valid:] = 0
    batch["weights"] = (np.arange(B) < valid).astype(np.float32)
    return batch
