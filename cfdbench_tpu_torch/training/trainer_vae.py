"""VAE trainer (port of ``cfdbench_tpu/training/trainer_vae.py``, the
reference's ``src/train_vae.py`` / ``train_vae_kl_annealing.py``).

- Loss: reconstruction MSE plus ``kl_weight`` · KL, each a weighted mean
  over the batch's valid rows (the padding rows of the last batch count for
  nothing). Training samples the posterior, its noise keyed
  ``vae_key(seed, step)`` (JAX's ``fold_in(PRNGKey(seed + 31337), step)``,
  ``utils/rng.py``); validation uses its mean, at the epoch's weight.
- KL annealing: ``w = kl_weight · min(1, (ep + 1) / E)`` when
  ``kl_annealing_epochs`` E > 0.
- Adam, or AdamW when ``weight_decay`` > 0 (optax's decay is decoupled and
  multiplied by lr, as torch's is). The plateau rule and early stopping
  keep the original's strict tests: after ``plateau > lr_patience`` epochs
  without a new best the rate is multiplied by ``lr_factor`` and the count
  restarts; ``patience > early_stopping_patience`` stops the run.
- Each new best's weights go to ``weights_path/model.pt``; each epoch writes
  ``training_state/`` (weights, optimizer with its current rate, step) and
  ``training_meta.json`` (``cur_lr``, ``patience``, ``plateau``,
  ``global_step``, ``history``), from which ``resume`` continues; the run
  ends with ``loss_history.json``, ``train_loss.png`` and ``val_loss.png``.
- Per-step losses stay on the device, one transfer per epoch.
- Data parallelism (``mesh``, ``parallel/mesh.py``): every rank builds
  the same global batches, padded to a multiple of the rank count with
  weight-0 rows, and runs its block of rows; the posterior noise is drawn
  over the global batch and sliced, the weighted means are the global
  batch's (``DataMesh.weighted_mean``) and the gradients are averaged over
  the ranks before the update. Every rank so reads the same dev loss, cuts
  its rate and stops on the same epoch. Rank 0 writes every file and the
  others wait for it at a barrier.
- Tensor parallelism (``--mesh_shape NxM``): for the length of
  :func:`train_vae` the VAE is split over the model axis by the JAX rules
  and gathers its slices at use (``trainer_auto.split_module``); Adam acts
  on each rank's slices. The best weights and ``training_state/`` are
  gathered into the one-process layout on every rank before rank 0 writes
  them, so the weights load into a latent model in one process and a run
  resumes on any mesh.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.core import dump_json, load_json
from ..data.pipeline import batches, to_device
from ..data.vae_data import VaeDataset
from ..models.vae import AutoencoderKL
from ..parallel.mesh import SINGLE, DataMesh
from ..utils.artifacts import plot_loss
from ..utils.rng import vae_key
from . import checkpoints
from .trainer_auto import (ModelSplit, join_split, reduce_gradients, split_module,
                           whole_state)

PARTS = ("total", "recon", "kl")


def host_copy(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of a state dict on the host (not an alias on the CPU)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def loss_parts(vae: AutoencoderKL, frames, w, kl_weight: float, key=None,
               mesh: DataMesh = SINGLE) -> torch.Tensor:
    """``(3,)``: total, reconstruction and KL loss of one batch, each a
    mean over its valid (weight-1) rows; the posterior sampled with
    ``key``, or its mean when it is None. ``frames`` and ``w`` are
    ``mesh``'s block of the batch."""
    recon, posterior = vae(frames, key, mesh)
    recon_loss, kl_loss = mesh.weighted_mean(
        torch.stack([(recon - frames).square().mean(dim=(1, 2, 3)), posterior.kl()], -1), w)
    return torch.stack([recon_loss + kl_weight * kl_loss, recon_loss, kl_loss])


def train_step(vae: AutoencoderKL, opt: torch.optim.Optimizer, frames, w, kl_weight: float,
               key, mesh: DataMesh = SINGLE, split: Optional[ModelSplit] = None
               ) -> torch.Tensor:
    """One update on a posterior sample drawn with ``key``; returns the
    ``(3,)`` loss parts, detached, on the device. Under data parallelism
    the gradients are averaged over the ranks before the update, and
    under tensor parallelism (``split``) first reduced over the model
    ranks (``trainer_auto.reduce_gradients``)."""
    opt.zero_grad(set_to_none=True)
    parts = loss_parts(vae, frames, w, kl_weight, key, mesh)
    parts[0].backward()
    reduce_gradients(mesh, split, vae.parameters())
    opt.step()
    return parts.detach()


def make_optimizer(vae: AutoencoderKL, lr: float, weight_decay: float):
    if weight_decay > 0:
        return torch.optim.AdamW(vae.parameters(), lr, weight_decay=weight_decay)
    return torch.optim.Adam(vae.parameters(), lr)


def train_vae(
    vae: AutoencoderKL,
    train_data: VaeDataset,
    dev_data: VaeDataset,
    output_dir: Path,
    weights_path: Path,
    *,
    device: torch.device,
    num_epochs: int = 100,
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    batch_size: int = 8,
    kl_weight: float = 1e-4,
    kl_annealing_epochs: int = 0,
    lr_factor: float = 0.5,
    lr_patience: int = 5,
    early_stopping_patience: int = 20,
    early_stopping_delta: float = 1e-5,
    seed: int = 0,
    resume: bool = False,
    mesh: DataMesh = SINGLE,
) -> Dict[str, torch.Tensor]:
    """Train ``vae`` in place; returns the best weights, a state dict on
    the host in the one-process layout. Under data parallelism (``mesh``)
    ``batch_size`` is global; with a model axis the VAE is split for the
    run and whole again when it returns."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    n_params = sum(p.numel() for p in vae.parameters())
    split = split_module(vae, mesh)
    layout = None if split is None else split.layout
    opt = make_optimizer(vae, lr, weight_decay)
    print(f"VAE has {n_params} parameters" + (
        f" ({sum(p.numel() for p in vae.parameters())} on this rank)" if split else ""))

    history = {f"{part}_{k}": [] for part in ("train", "val") for k in PARTS}
    history["val_steps"] = []
    best_val, patience, plateau, cur_lr = np.inf, 0, 0, lr
    best_params = host_copy(whole_state(vae, split))
    start, global_step, start_epoch = time.time(), 0, 0

    meta_path = output_dir / "training_meta.json"
    state_dir = output_dir / checkpoints.STATE_DIR
    if resume and meta_path.exists() and state_dir.exists():
        meta = load_json(meta_path)
        state = checkpoints.load_params(state_dir)
        vae.load_state_dict(state["params"] if layout is None
                            else layout.from_std(state["params"]))
        checkpoints.optimizer_from_std(state["optimizer"], opt, layout)
        start_epoch = meta["epoch"] + 1
        best_val, patience, plateau = meta["best_val"], meta["patience"], meta["plateau"]
        cur_lr, global_step, history = meta["cur_lr"], meta["global_step"], meta["history"]
        if (Path(weights_path) / checkpoints.MODEL_FILE).exists():
            best_params = checkpoints.load_params(weights_path)
        print(f"Resumed from epoch {meta['epoch']}")

    train_arrays, dev_arrays = dict(frames=train_data.frames), dict(frames=dev_data.frames)
    for ep in range(start_epoch, num_epochs):
        w = kl_weight * min(1.0, (ep + 1) / kl_annealing_epochs) if kl_annealing_epochs > 0 \
            else kl_weight
        vae.train()
        rows = []
        rng = np.random.default_rng(seed * 7919 + ep)
        for host in batches(train_arrays, batch_size, shuffle=True, rng=rng,
                            pad_multiple=mesh.size):
            batch = to_device(mesh.block(host), device)
            rows.append(train_step(vae, opt, batch["frames"], batch["weights"], w,
                                   vae_key(seed, global_step), mesh, split))
            global_step += 1
        if rows:
            mat = torch.stack(rows).cpu().numpy()
            for j, k in enumerate(PARTS):
                history[f"train_{k}"] += mat[:, j].tolist()

        vae.eval()
        with torch.no_grad():
            rows = [loss_parts(vae, b["frames"], b["weights"], w, mesh=mesh)
                    for b in (to_device(mesh.block(h), device)
                              for h in batches(dev_arrays, batch_size, shuffle=False,
                                               pad_multiple=mesh.size))]
        val = torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 3))
        val_total = float(np.mean(val[:, 0]))
        for j, k in enumerate(PARTS):
            history[f"val_{k}"].append(float(np.mean(val[:, j])))
        history["val_steps"].append(global_step)
        print(f"ep {ep}: val_total={val_total:.6f} val_recon={np.mean(val[:, 1]):.6f} "
              f"val_kl={np.mean(val[:, 2]):.4f} lr={cur_lr:.2e} kl_w={w:.2e} "
              f"time={time.time() - start:.0f}s")

        if val_total < best_val - early_stopping_delta:
            best_val, patience, plateau = val_total, 0, 0
            best_params = host_copy(whole_state(vae, split))
            if mesh.is_main():
                checkpoints.save_params(best_params, weights_path)
                print(f"  new best; weights saved to {weights_path}")
        else:
            patience += 1
            plateau += 1
            if plateau > lr_patience:
                cur_lr *= lr_factor
                for group in opt.param_groups:
                    group["lr"] = cur_lr
                plateau = 0
                print(f"  plateau: lr reduced to {cur_lr:.2e}")
        params = whole_state(vae, split)  # on every rank
        opt_state = checkpoints.optimizer_to_std(opt, layout)
        if mesh.is_main():
            checkpoints.save_params(dict(params=params, optimizer=opt_state,
                                         step=global_step), state_dir)
            dump_json(dict(epoch=ep, best_val=float(best_val), patience=patience,
                           plateau=plateau, cur_lr=cur_lr, global_step=global_step,
                           history=history), meta_path)
        mesh.barrier()
        if patience > early_stopping_patience:
            print("Early stopping.")
            break

    join_split(vae, split)
    if mesh.is_main():
        dump_json(history, output_dir / "loss_history.json")
        plot_loss(history["train_total"], output_dir / "train_loss.png")
        plot_loss(history["val_total"], output_dir / "val_loss.png")
    mesh.barrier()
    return best_params
