"""Non-autoregressive trainer (port of
``cfdbench_tpu/training/trainer_nonauto.py``, the ``train.py`` engine;
the reference's ``src/train.py``).

- :class:`NonAutoTask`: every train step regresses u at
  ``num_label_samples`` (1000) lattice points drawn with replacement
  (the reference draws them inside its forward,
  ``src/models/deeponet.py:170-191``); evaluation queries the whole
  row-major lattice in one call (``generate_one``) and scores against
  the full u frame, unmasked.
- :func:`sample_query_idxs` draws a step's points from a
  ``torch.Generator`` seeded from ``(seed + 777, global step)``, on the
  CPU whatever the device, so a ``--resume`` run, a straight run and a
  run on another device draw the same points. The JAX package draws
  with ``jax.random.randint`` from ``fold_in(PRNGKey(seed + 777),
  step)``; torch has no threefry, so no run of the port can draw JAX's
  points bit for bit. The tests that hold the trainer to the JAX
  package replace this one function with JAX's own draws.
- :func:`evaluate` runs batches of 64 (the JAX package's default; the
  ``--eval_batch_size`` flag does not reach this trainer there either),
  the last one padded with weight-0 samples.
- :func:`train` writes the JAX package's artifacts: per eval epoch
  ``ckpt-{ep}/{model.pt, dev_loss.json, train_loss.json, scores.json}``
  (the reference's non-auto eval file is ``dev_loss.json``, not the
  autoregressive trainer's ``dev_scores.json``), the ``training_state/``
  snapshot and ``training_meta.json`` for ``--resume``, and at the end
  ``train_losses.json``/``.png``.
- :func:`test` writes ``preds.npy``, prediction plots and ``scores.json``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..data.core import dump_json, load_json
from ..data.datasets import FrameDataset
from ..data.pipeline import batches, num_batches, to_device
from ..metrics import LossFn
from ..models.point import lattice_xy
from ..utils.artifacts import plot_loss, plot_predictions
from . import checkpoints
from .optim import make_adam, step_lr_schedule

NUM_LABEL_SAMPLES = 1000
EVAL_BATCH = 64


class NonAutoTask:
    """Couples a ``(case_params, t, query_xy) → (B, k)`` model with the
    reference's point-sampled loss."""

    num_label_samples = NUM_LABEL_SAMPLES

    def __init__(self, model: nn.Module, loss_fn: Optional[LossFn] = None):
        self.model = model
        self.loss_fn = loss_fn

    def loss_scores(self, batch, query_idxs):
        """``(loss, scores)`` at the (k, 2) lattice points ``query_idxs``
        (row, col), against the batch's u labels there."""
        preds = self.model(batch["case_params"], batch["t"], query_idxs.float())
        labels = batch["labels"][..., 0][:, query_idxs[:, 0], query_idxs[:, 1]]  # (B, k)
        scores = self.loss_fn(preds, labels, sample_weights=batch.get("weights"))
        return scores[self.loss_fn.objective], scores

    def generate_one(self, case_params, t, height: int, width: int):
        """The whole row-major lattice in one call → (B, H, W, 1)
        (``deeponet.py:225-257``)."""
        qxy = lattice_xy(height, width, device=case_params.device)
        return self.model(case_params, t, qxy).reshape(-1, height, width, 1)


def sample_query_idxs(seed: int, step: int, k: int, height: int, width: int) -> torch.Tensor:
    """Global step ``step``'s (k, 2) int64 lattice points, rows in
    [0, height) and columns in [0, width), drawn with replacement on the
    CPU from a generator seeded from ``(seed + 777, step)`` alone."""
    state = np.random.SeedSequence([seed + 777, step]).generate_state(1)[0]
    gen = torch.Generator().manual_seed(int(state))
    rows = torch.randint(0, height, (k,), generator=gen)
    cols = torch.randint(0, width, (k,), generator=gen)
    return torch.stack([rows, cols], dim=-1)


def draw_query_idxs(seed: int, step: int, k: int, height: int, width: int,
                    device: torch.device) -> torch.Tensor:
    """:func:`sample_query_idxs` on ``device``: on a CUDA device through
    pinned memory, without making the host wait."""
    idxs = sample_query_idxs(seed, step, k, height, width)
    if torch.device(device).type == "cuda":
        return idxs.pin_memory().to(device, non_blocking=True)
    return idxs


def train_step(task: NonAutoTask, optimizer: torch.optim.Optimizer, scheduler, batch,
               query_idxs) -> Dict[str, torch.Tensor]:
    """One update at ``query_idxs``; returns the scores, detached, on the
    device."""
    optimizer.zero_grad(set_to_none=True)
    loss, scores = task.loss_scores(batch, query_idxs)
    loss.backward()
    optimizer.step()
    scheduler.step()
    return {k: v.detach() for k, v in scores.items()}


@torch.no_grad()
def eval_step(task: NonAutoTask, batch):
    """``(scores, preds)`` of the whole lattice against the u frame."""
    H, W = batch["labels"].shape[1:3]
    preds = task.generate_one(batch["case_params"], batch["t"], H, W)
    scores = task.loss_fn(preds, batch["labels"][..., :1], sample_weights=batch.get("weights"))
    return scores, preds


def dataset_arrays(data: FrameDataset) -> Dict[str, np.ndarray]:
    return dict(case_params=data.case_params, t=data.frame_t[:, None], labels=data.frames)


def evaluate(
    task: NonAutoTask,
    data: FrameDataset,
    output_dir: Path,
    *,
    device: torch.device,
    batch_size: int = EVAL_BATCH,
    collect_preds: bool = False,
) -> Dict[str, Any]:
    """Per-batch scores, their means and, if asked for, the predictions
    (``src/train.py:64-113``); ``loss.png`` of the per-batch nmse."""
    names = task.loss_fn.get_score_names()
    score_rows, all_preds, n_valids = [], [], []  # scores stay on the device
    task.model.eval()
    for host in batches(dataset_arrays(data), batch_size, shuffle=False):
        n_valids.append(int(host["weights"].sum()))
        s, preds = eval_step(task, to_device(host, device))
        score_rows.append(torch.stack([s[k] for k in names]))
        if collect_preds:
            all_preds.append(preds)
    # One device-to-host transfer for every batch's scores.
    mat = (torch.stack(score_rows).cpu().numpy() if score_rows
           else np.zeros((0, len(names))))
    scores = {k: mat[:, i].tolist() for i, k in enumerate(names)}
    avg = {k: float(np.mean(v)) for k, v in scores.items()}
    for k, v in avg.items():
        print(f"{k}: {v}")
    if "nmse" in scores:
        plot_loss(scores["nmse"], Path(output_dir) / "loss.png")
    result: Dict[str, Any] = dict(scores=dict(mean=avg, all=scores))
    if collect_preds:
        result["preds"] = (np.concatenate([p[:nv].cpu().numpy()
                                           for p, nv in zip(all_preds, n_valids)])
                           if all_preds else None)
    return result


def train(
    task: NonAutoTask,
    train_data: FrameDataset,
    dev_data: FrameDataset,
    output_dir: Path,
    *,
    device: torch.device,
    num_epochs: int = 400,
    lr: float = 1e-3,
    lr_step_size: int = 1,
    lr_gamma: float = 0.9,
    batch_size: int = 64,
    log_interval: int = 50,
    eval_interval: int = 2,
    seed: int = 0,
    measure_time: bool = False,
    resume: bool = False,
) -> List[float]:
    """Train ``task.model`` in place; returns the per-step losses.
    ``resume=True`` continues from ``output_dir/training_state`` and
    ``training_meta.json`` when both are there; every eval epoch writes
    them."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    model = task.model
    H, W = train_data.field_shape
    steps_per_epoch = num_batches(len(train_data), batch_size)
    optimizer, scheduler = make_adam(model.parameters(), lr, gamma=lr_gamma,
                                     lr_step_size=lr_step_size, steps_per_epoch=steps_per_epoch)
    # For the log only; the optimizer's rate comes from the same rule.
    lr_schedule = step_lr_schedule(lr, lr_gamma, lr_step_size, steps_per_epoch)
    arrays = dataset_arrays(train_data)

    start_epoch, global_step, train_losses = 0, 0, []
    meta_path = output_dir / "training_meta.json"
    if resume and meta_path.exists() and (output_dir / checkpoints.STATE_DIR).exists():
        meta = load_json(meta_path)
        global_step = checkpoints.load_training_state(output_dir, model, optimizer, scheduler)
        start_epoch = meta["epoch"] + 1
        # Truncated to the committed epoch: a finished run's final dump
        # holds epochs past the last snapshot, which are trained again.
        losses_path = output_dir / "train_losses.json"
        train_losses = load_json(losses_path) if losses_path.exists() else []
        train_losses = train_losses[: start_epoch * steps_per_epoch]
        print(f"Resumed from epoch {meta['epoch']}")

    print(f"Model has {sum(p.numel() for p in model.parameters())} parameters")
    print("==== Training ====")
    print(f"# lr: {lr}")
    print(f"# batch: {batch_size}")
    print(f"# examples: {len(train_data)}")
    print(f"# step: {steps_per_epoch}")
    print(f"# epoch: {num_epochs}")

    start_time = time.time()
    objective = task.loss_fn.objective
    for ep in range(start_epoch, num_epochs):
        ep_start = time.time()
        model.train()
        ep_losses_dev = []  # on the device: a float() here would wait for every step
        rng = np.random.default_rng(seed * 999_983 + ep)
        for host in batches(arrays, batch_size, shuffle=True, rng=rng):
            query_idxs = draw_query_idxs(seed, global_step, task.num_label_samples, H, W, device)
            scores = train_step(task, optimizer, scheduler, to_device(host, device), query_idxs)
            ep_losses_dev.append(scores[objective])
            global_step += 1
            if global_step % log_interval == 0 and not measure_time:
                print(dict(ep=ep, step=global_step, loss=f"{float(scores[objective]):.3e}",
                           lr=f"{lr_schedule(global_step - 1):.3e}",
                           time=round(time.time() - start_time)))
        ep_losses = torch.stack(ep_losses_dev).tolist() if ep_losses_dev else []
        if measure_time:
            print("Time usage:")
            print(time.time() - ep_start)
            return ep_losses

        train_losses += ep_losses
        if (ep + 1) % eval_interval == 0:
            ckpt_dir = output_dir / f"ckpt-{ep}"
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            dev_scores = evaluate(task, dev_data, ckpt_dir, device=device)["scores"]
            dump_json(dev_scores, ckpt_dir / "dev_loss.json")
            dump_json(ep_losses, ckpt_dir / "train_loss.json")
            dev_key = "nmse" if "nmse" in dev_scores["mean"] else objective
            checkpoints.save_checkpoint(
                model.state_dict(), ckpt_dir, ep=ep, train_loss=float(np.mean(ep_losses)),
                dev_loss=float(dev_scores["mean"][dev_key]), time=time.time() - ep_start)
            checkpoints.save_training_state(output_dir, model, optimizer, scheduler,
                                            global_step)
            # Losses before meta: training_meta.json commits the snapshot.
            dump_json(train_losses, output_dir / "train_losses.json")
            dump_json(dict(epoch=ep, global_step=global_step), meta_path)
    dump_json(train_losses, output_dir / "train_losses.json")
    plot_loss(train_losses, output_dir / "train_losses.png")
    return train_losses


def test(
    task: NonAutoTask,
    data: FrameDataset,
    output_dir: Path,
    *,
    device: torch.device,
    batch_size: int = 1,
) -> None:
    """Test-split scores of the whole lattice per frame: ``preds.npy``
    (N, H, W, 1), u prediction plots of about five frames under
    ``images/`` (``src/train.py:76-80``) and ``scores.json``."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    result = evaluate(task, data, output_dir, device=device, batch_size=batch_size,
                      collect_preds=True)
    preds = result["preds"]
    if preds is not None:
        np.save(output_dir / "preds.npy", preds)
        for i in range(0, preds.shape[0], max(1, preds.shape[0] // 5)):
            plot_predictions(inp=None, label=data.frames[i, ..., 0], pred=preds[i, ..., 0],
                             out_dir=output_dir / "images", step=i)
    dump_json(result["scores"], output_dir / "scores.json")
