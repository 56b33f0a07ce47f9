"""Unconditional DDPM trainer with an EMA of the weights (port of
``cfdbench_tpu/training/trainer_uncond.py``, the counterpart of the
reference's stock ``src/train_diffusers.py``, wired to the CFDBench
frames).

- Network: ``PUNetGCFD(C, C, base_channels, n_case_params=1)`` at its
  default mults and dropout, driven by zero case parameters.
- Step: noise and timesteps (``diffusion.train_noise_and_t``) and the
  dropout masks (``punetg.dropout_keep_masks``) from ``uncond_key(seed, step)``,
  JAX's ``fold_in(PRNGKey(seed + 99), step)`` split in three
  (``utils/rng.py``); the loss a weighted mean over the valid rows of the
  per-sample noise mse; ``optax.adamw(lr)``, whose weight decay is 1e-4
  (torch's ``AdamW`` defaults to 1e-2); after each update ``ema = d·ema +
  (1 − d)·params``, the EMA starting as a copy of the initial weights.
- Every ``SAMPLE_EVERY`` epochs, 4 frames sampled from the EMA weights with
  the fixed evaluation key (JAX's ``PRNGKey(0)``) go to
  ``samples-ep{ep}.png`` and the EMA weights to ``ema_model/``; each epoch
  writes ``training_state/`` (weights, EMA, optimizer, step) and
  ``training_meta.json``, from which ``resume`` continues; the run ends
  with ``train_losses.json`` and ``ema_model/``.
- Data parallelism (``mesh``, ``parallel/mesh.py``): every rank builds the
  same global batches, padded to a multiple of the rank count with
  weight-0 rows, and runs its block of rows; the noise, the timesteps and
  the dropout masks are drawn over the global batch and sliced, the loss
  is the global batch's weighted mean, and the gradients are averaged over
  the ranks before the update, so the EMA follows the same update on every
  rank. Rank 0 samples, writes every file, and the others wait for it at a
  barrier.
- Tensor parallelism (``--mesh_shape NxM``): for the length of
  :func:`train_uncond_ddpm` the PUNetG and its EMA copy are split over the
  model axis by the JAX rules and gather their slices at use
  (``trainer_auto.split_module``); AdamW and the EMA update act on each
  rank's slices. Every forward of a split network is a collective over the
  model ranks, so every model rank of data rank 0 samples the EMA's
  frames, and rank 0 plots them. ``ema_model/`` and ``training_state/``
  are gathered into the one-process layout on every rank before rank 0
  writes them, so a run resumes on any mesh.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.core import dump_json, load_json
from ..data.pipeline import batches, to_device
from ..models.diffusion import train_noise_and_t
from ..models.punetg import PUNetGCFD, dropout_keep_masks
from ..ops.diffusion import DDPMScheduler, ddpm_sample, make_ddpm_scheduler
from ..parallel.mesh import SINGLE, DataMesh
from ..utils.rng import EVAL_KEY, Key, uncond_key
from . import checkpoints
from .trainer_auto import (ModelSplit, join_split, reduce_gradients, split_module,
                           whole_state)

# optax.adamw's default weight decay.
WEIGHT_DECAY = 1e-4
EMA_DECAY = 0.9999
SAMPLE_EVERY = 10  # epochs
EMA_DIR = "ema_model"


def make_unet(C: int, base_channels: int, seed: int, device) -> PUNetGCFD:
    return PUNetGCFD(C, C, base_channels, n_case_params=1,
                     generator=torch.Generator().manual_seed(seed), device=device)


def step_loss(unet: PUNetGCFD, scheduler: DDPMScheduler, x, w, key: Key,
              mesh: DataMesh = SINGLE) -> torch.Tensor:
    """The weighted mean noise mse of one train step (dropout on) over the
    global batch, of which ``x`` and ``w`` are ``mesh``'s block; the draws
    are made over the global batch and sliced."""
    shape = mesh.global_shape(x.shape)
    noise, t = map(mesh.block, train_noise_and_t(key, shape, scheduler.num_train_timesteps,
                                                 x.device))
    noisy = scheduler.add_noise(x, noise, t)
    masks = [mesh.block(m) for m in dropout_keep_masks(key, unet.dropout_shapes(shape),
                                                       unet.dropout, x.device)]
    eps = unet(noisy, t, x.new_zeros((x.shape[0], 1)), masks)
    return mesh.weighted_mean((eps - noise).square().mean(dim=(1, 2, 3)), w)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1 - decay)


def train_step(unet: PUNetGCFD, ema: PUNetGCFD, opt: torch.optim.Optimizer,
               scheduler: DDPMScheduler, x, w, key: Key,
               mesh: DataMesh = SINGLE, split: Optional[ModelSplit] = None) -> torch.Tensor:
    """One update of ``unet`` and then of its EMA ``ema``; returns the
    loss, detached, on the device. Under data parallelism the gradients
    are averaged over the ranks before the update, and under tensor
    parallelism (``split``) first reduced over the model ranks
    (``trainer_auto.reduce_gradients``)."""
    opt.zero_grad(set_to_none=True)
    loss = step_loss(unet, scheduler, x, w, key, mesh)
    loss.backward()
    reduce_gradients(mesh, split, unet.parameters())
    opt.step()
    ema_update(list(ema.parameters()), list(unet.parameters()), EMA_DECAY)
    return loss.detach()


def train_uncond_ddpm(
    frames: np.ndarray,
    output_dir: Path,
    *,
    device: torch.device,
    num_epochs: int = 50,
    lr: float = 1e-4,
    batch_size: int = 16,
    timesteps: int = 1000,
    base_channels: int = 64,
    seed: int = 0,
    resume: bool = False,
    mesh: DataMesh = SINGLE,
) -> Tuple[PUNetGCFD, PUNetGCFD, List[float]]:
    """Train on ``frames`` (N, H, W, C); returns the network, its EMA (a
    second network holding the EMA weights) and the per-step losses.
    Under data parallelism (``mesh``) ``batch_size`` is global; with a
    model axis both networks are split for the run and whole again when it
    returns."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    N, H, W, C = frames.shape
    scheduler = make_ddpm_scheduler(timesteps, device=device)
    unet = make_unet(C, base_channels, seed, device)
    ema = make_unet(C, base_channels, seed, device).eval().requires_grad_(False)
    ema.load_state_dict(unet.state_dict())
    split, ema_split = split_module(unet, mesh), split_module(ema, mesh)
    layout = None if split is None else split.layout
    opt = torch.optim.AdamW(unet.parameters(), lr, weight_decay=WEIGHT_DECAY)

    losses: List[float] = []
    step, start_epoch, start = 0, 0, time.time()
    meta_path = output_dir / "training_meta.json"
    state_dir = output_dir / checkpoints.STATE_DIR
    if resume and meta_path.exists() and state_dir.exists():
        meta = load_json(meta_path)
        state = checkpoints.load_params(state_dir)
        unet.load_state_dict(state["params"] if layout is None
                             else layout.from_std(state["params"]))
        ema.load_state_dict(state["ema_params"] if layout is None
                            else layout.from_std(state["ema_params"]))
        checkpoints.optimizer_from_std(state["optimizer"], opt, layout)
        step, start_epoch, losses = state["step"], meta["epoch"] + 1, meta["losses"]
        print(f"Resumed from epoch {meta['epoch']}")

    for ep in range(start_epoch, num_epochs):
        unet.train()
        rows = []
        rng = np.random.default_rng(seed * 65537 + ep)
        for host in batches(dict(x=frames), batch_size, shuffle=True, rng=rng,
                            pad_multiple=mesh.size):
            batch = to_device(mesh.block(host), device)
            rows.append(train_step(unet, ema, opt, scheduler, batch["x"], batch["weights"],
                                   uncond_key(seed, step), mesh, split))
            step += 1
        if rows:
            losses += torch.stack(rows).tolist()
        print(f"ep {ep}: loss={np.mean(losses[-10:]):.5f} time={time.time() - start:.0f}s")
        if (ep + 1) % SAMPLE_EVERY == 0 and mesh.rank == 0:
            # Rank 0 and, under tp, the model ranks whose gathers its forwards need.
            sample_grid(ema, scheduler, (4, H, W, C),
                        output_dir / f"samples-ep{ep}.png" if mesh.is_main() else None)
        # The one-process layout, gathered on every rank.
        params, ema_params = whole_state(unet, split), whole_state(ema, ema_split)
        opt_state = checkpoints.optimizer_to_std(opt, layout)
        if mesh.is_main():
            if (ep + 1) % SAMPLE_EVERY == 0:
                checkpoints.save_params(ema_params, output_dir / EMA_DIR)
            checkpoints.save_params(dict(params=params, ema_params=ema_params,
                                         optimizer=opt_state, step=step), state_dir)
            dump_json(dict(epoch=ep, losses=losses), meta_path)
        mesh.barrier()
    join_split(unet, split)
    join_split(ema, ema_split)
    if mesh.is_main():
        dump_json(losses, output_dir / "train_losses.json")
        checkpoints.save_params(ema.state_dict(), output_dir / EMA_DIR)
    mesh.barrier()
    return unet, ema, losses


def sample_grid(unet: PUNetGCFD, scheduler: DDPMScheduler, shape, out_path,
                num_inference_steps: int = 50) -> torch.Tensor:
    """``shape[0]`` frames sampled from ``unet`` with the evaluation key,
    the first channel of each plotted side by side to ``out_path`` (None:
    no plot)."""
    def denoise(x, t):
        return unet(x, t, x.new_zeros((x.shape[0], 1)))

    device = next(unet.parameters()).device
    samples = ddpm_sample(scheduler, denoise, shape, EVAL_KEY, num_inference_steps, device)
    if out_path is None:
        return samples
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = shape[0]
    fig, axs = plt.subplots(1, n, figsize=(3 * n, 3))
    for ax, s in zip(np.atleast_1d(axs), samples.cpu().numpy()):
        ax.imshow(s[..., 0])
        ax.axis("off")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return samples
