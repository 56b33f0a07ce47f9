"""Autoregressive trainer (port of
``cfdbench_tpu/training/trainer_auto.py``, the ``train_auto`` engine).

- :class:`AutoTask` couples a model with its loss. Field models (FNO,
  U-Net, ResNet): masked (B, H, W, C) predictions against mask-multiplied
  labels over all channels. Point models (the DeepONet family,
  ``pointwise``): (B, H*W) u predictions against the flattened u labels,
  unmasked; their rollout feeds back the 1-channel u frame. Losses in
  float32, with the batch's 0/1 sample weights.
- :func:`train_step`: forward, loss, backward, Adam update and one
  schedule step. On the card the FNO's forward runs every FnoBlock and
  the head on their kernels (``ops/fno_kernels.py``), whose autograd
  Functions carry the gradient. A task's random draws are a function of
  ``(seed, global step)`` (``task.step_draws``): a generator for a model
  that draws in training (the ResNet's dropout), the key of a diffusion
  task (``models/diffusion.py``), so a resumed run draws what a straight
  run draws. BatchNorm's running statistics are buffers of the model:
  ``state_dict`` carries them into every checkpoint and the
  ``training_state/`` snapshot.
- :func:`evaluate` scores each batch and the input-as-prediction
  persistence baseline (``src/train_auto.py:92-97, 132-139``) under
  ``torch.no_grad``; the scores stay on the device until one transfer at
  the end. A generative task (``task.generative``) is scored on the frame
  it generates, masked, against the masked label, beside the masked
  persistence baseline (the reference's ``evaluate_ldm``), on at most
  ``max_eval_batches`` batches.
- :func:`train` writes the JAX package's artifacts: per eval epoch
  ``ckpt-{ep}/{model.pt, dev_scores.json, train_loss.json,
  scores.json}`` and ``example.png``, the ``training_state/`` snapshot
  and ``training_meta.json`` for ``--resume``, and at the end
  ``train_losses.json``/``.png``. Per-step losses stay on the device,
  with one transfer per epoch.
- :func:`test` writes ``test/preds.npy`` and ``test/scores.json``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..data.core import dump_json, load_json
from ..data.datasets import AutoDataset
from ..data.pipeline import batches, num_batches, to_device
from ..metrics import LossFn
from ..utils.artifacts import plot_example, plot_loss, plot_predictions
from ..utils.rng import step_generator
from . import checkpoints
from .optim import make_adam, step_lr_schedule


class AutoTask:
    """Couples an autoregressive model with its loss and its rollout
    contract."""

    generative = False

    def __init__(self, model: nn.Module, loss_fn: Optional[LossFn] = None):
        self.model = model
        self.loss_fn = loss_fn
        self.pointwise = getattr(model, "pointwise", False)

    def forward(self, inputs, case_params, mask, generator=None):
        """The model's own output: (B, H, W, C) for a field model, (B, H*W)
        for a point model. ``generator`` goes to a model that draws in
        training."""
        if generator is None:
            return self.model(inputs, case_params, mask)
        return self.model(inputs, case_params, mask, generator=generator)

    def as_frame(self, out, inputs):
        """A forward's output as a (B, H, W, C) frame."""
        if self.pointwise:
            return out.reshape(*inputs.shape[:3], 1)
        return out

    def predict_frame(self, inputs, case_params, mask):
        """Full-field next-frame prediction."""
        return self.as_frame(self.forward(inputs, case_params, mask), inputs)

    def scores(self, out, batch) -> Dict[str, torch.Tensor]:
        """The loss dict of a forward's output against the batch's labels
        (masked for a field model, the flat u for a point model), in
        float32, weighted by the batch's ``weights``."""
        if self.pointwise:
            labels = batch["labels"][..., 0].reshape(out.shape[0], -1)
        else:
            labels = batch["labels"] * batch["mask"]
        return self.loss_fn(out.float(), labels, sample_weights=batch.get("weights"))

    def loss_scores(self, batch, generator=None):
        """``(loss, scores)`` of one forward on ``batch``."""
        s = self.scores(self.forward(batch["inputs"], batch["case_params"], batch["mask"],
                                     generator), batch)
        return s[self.loss_fn.objective], s

    @property
    def feedback_channels(self) -> int:
        """Channels carried through the rollout, the model's outputs: the
        point models feed back their 1-channel u prediction (the
        reference's quirk)."""
        return self.model.out_chan

    def step_draws(self, seed: int, step: int, device) -> Optional[torch.Generator]:
        """What ``loss_scores`` takes for train step ``step``: the step's
        generator for a model that draws in training, else None."""
        if getattr(self.model, "draws_in_training", False):
            return step_generator(seed, step, device)
        return None


def train_step(task: AutoTask, optimizer: torch.optim.Optimizer, scheduler,
               batch, draws=None) -> Dict[str, torch.Tensor]:
    """One update; returns the batch's scores, detached, on the device.
    ``draws`` is the step's ``task.step_draws``."""
    optimizer.zero_grad(set_to_none=True)
    loss, scores = task.loss_scores(batch, draws)
    loss.backward()
    optimizer.step()
    scheduler.step()
    return {k: v.detach() for k, v in scores.items()}


@torch.no_grad()
def eval_step(task: AutoTask, batch, with_preds: bool = True):
    """``(scores, input_scores, preds or None)``: one forward, and the
    persistence baseline — input u as the prediction of label u,
    unmasked (``src/train_auto.py:92-97``)."""
    out = task.forward(batch["inputs"], batch["case_params"], batch["mask"])
    input_scores = task.loss_fn(batch["inputs"][..., :1], batch["labels"][..., :1],
                                sample_weights=batch.get("weights"))
    preds = task.as_frame(out, batch["inputs"]) if with_preds else None
    return task.scores(out, batch), input_scores, preds


@torch.no_grad()
def gen_eval_step(task, batch):
    """``(scores, input_scores, frame)`` of a generative task: the frame
    generated from the fixed evaluation key, masked, against the masked
    label, and the masked persistence baseline
    (``src/train_gencast.py:176-180``)."""
    frame = task.predict_frame(batch["inputs"], batch["case_params"], batch["mask"])
    oc = frame.shape[-1]
    w = batch.get("weights")
    labels = batch["labels"][..., :oc] * batch["mask"]
    scores = task.loss_fn(frame * batch["mask"], labels, sample_weights=w)
    input_scores = task.loss_fn(batch["inputs"][..., :oc] * batch["mask"], labels,
                                sample_weights=w)
    return scores, input_scores, frame


def dataset_arrays(data: AutoDataset) -> Dict[str, np.ndarray]:
    return dict(inputs=data.inputs, labels=data.labels, mask=data.masks,
                case_params=data.case_params)


def evaluate(
    task: AutoTask,
    data: AutoDataset,
    output_dir: Path,
    *,
    device: torch.device,
    batch_size: int = 2,
    plot_interval: Optional[int] = None,
    collect_preds: bool = True,
    max_eval_batches: Optional[int] = None,
) -> Dict[str, Any]:
    """Mirror of ``src/train_auto.py:61-148``: per-batch scores, their
    means, the predictions if asked for, and the plots; at most
    ``max_eval_batches`` batches when given."""
    keep_preds = collect_preds or bool(plot_interval)
    names = task.loss_fn.get_score_names()
    score_rows = []  # (2, n_names) per batch, on the device: [pred, input baseline]
    all_preds, n_valids = [], []
    plot_panels = {}  # step -> (input u, label u) of the batch's first sample
    task.model.eval()
    for step, host in enumerate(batches(dataset_arrays(data), batch_size, shuffle=False)):
        if max_eval_batches is not None and step >= max_eval_batches:
            break
        n_valids.append(int(host["weights"].sum()))
        if plot_interval and step % plot_interval == 0:
            plot_panels[step] = (host["inputs"][0, ..., 0].copy(),
                                 host["labels"][0, ..., 0].copy())
        if task.generative:
            s, isc, preds = gen_eval_step(task, to_device(host, device))
        else:
            s, isc, preds = eval_step(task, to_device(host, device), with_preds=keep_preds)
        score_rows.append(torch.stack([torch.stack([s[k] for k in names]),
                                       torch.stack([isc[k] for k in names])]))
        if keep_preds:
            all_preds.append(preds)
    # One device-to-host transfer for every batch's scores.
    mat = (torch.stack(score_rows).cpu().numpy() if score_rows
           else np.zeros((0, 2, len(names))))
    scores = {k: mat[:, 0, i].tolist() for i, k in enumerate(names)}
    input_scores = {k: mat[:, 1, i].tolist() for i, k in enumerate(names)}
    preds_host = None
    if all_preds:
        stacked = torch.stack(all_preds).cpu().numpy()
        preds_host = np.concatenate([p[:nv] for p, nv in zip(stacked, n_valids)])
    if plot_interval and preds_host is not None and not task.pointwise:
        offsets = np.cumsum([0] + n_valids)
        for step, (inp_u, label_u) in plot_panels.items():
            plot_predictions(inp=inp_u, label=label_u, pred=preds_host[offsets[step], ..., 0],
                             out_dir=Path(output_dir) / "images", step=step)

    avg_scores = {}
    for k in names:
        avg_scores[k] = float(np.mean(scores[k]))
        avg_scores[f"input_{k}"] = float(np.mean(input_scores[k]))
    result: Dict[str, Any] = dict(scores=dict(mean=avg_scores, all=scores))
    if collect_preds:
        result["preds"] = preds_host
    if "nmse" in scores:
        plot_loss(scores["nmse"], Path(output_dir) / "loss.png")
    return result


def _print_memory(device: torch.device) -> None:
    print("Memory usage:")
    if device.type != "cuda":
        print("  (memory stats unavailable on this backend)")
        return
    for name, n in (("bytes_in_use", torch.cuda.memory_allocated(device)),
                    ("peak_bytes_in_use", torch.cuda.max_memory_allocated(device)),
                    ("bytes_limit", torch.cuda.get_device_properties(device).total_memory)):
        print(f"  {name}: {n / 2**20:.1f} MiB")


def train(
    task: AutoTask,
    train_data: AutoDataset,
    dev_data: AutoDataset,
    output_dir: Path,
    *,
    device: torch.device,
    num_epochs: int = 400,
    lr: float = 1e-3,
    lr_step_size: int = 1,
    lr_gamma: float = 0.9,
    batch_size: int = 2,
    eval_batch_size: int = 2,
    log_interval: int = 10,
    eval_interval: int = 2,
    seed: int = 0,
    measure_time: bool = False,
    plot_examples: bool = False,
    resume: bool = False,
    opt_state: str = "f32",
    eval_max_batches: Optional[int] = None,
) -> List[float]:
    """Train ``task.model`` in place; returns the per-step losses.
    ``resume=True`` continues from ``output_dir/training_state`` (the
    weights, the optimizer's moments and step, the schedule's position)
    and ``training_meta.json`` when both are there; every eval epoch
    writes them. ``eval_max_batches`` caps the dev evaluation."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    model = task.model
    steps_per_epoch = num_batches(len(train_data), batch_size)
    optimizer, scheduler = make_adam(model.parameters(), lr, gamma=lr_gamma,
                                     lr_step_size=lr_step_size,
                                     steps_per_epoch=steps_per_epoch, opt_state=opt_state)
    # For the log only; the optimizer's rate comes from the same rule.
    lr_schedule = step_lr_schedule(lr, lr_gamma, lr_step_size, steps_per_epoch)
    arrays = dataset_arrays(train_data)

    start_epoch, global_step, train_losses = 0, 0, []
    meta_path = output_dir / "training_meta.json"
    if resume and meta_path.exists() and (output_dir / checkpoints.STATE_DIR).exists():
        meta = load_json(meta_path)
        global_step = checkpoints.load_training_state(output_dir, model, optimizer, scheduler)
        start_epoch = meta["epoch"] + 1
        # The loss history is saved beside the state. Truncate it to the
        # committed epoch: a finished run's final dump holds epochs past
        # the last snapshot, which are about to be trained again.
        losses_path = output_dir / "train_losses.json"
        train_losses = load_json(losses_path) if losses_path.exists() else []
        train_losses = train_losses[: start_epoch * steps_per_epoch]
        print(f"Resumed from epoch {meta['epoch']}")

    print(f"Model has {sum(p.numel() for p in model.parameters())} parameters")
    print("====== Training ======")
    print(f"# batch: {batch_size}")
    print(f"# examples: {len(train_data)}")
    print(f"# step: {steps_per_epoch}")
    print(f"# epoch: {num_epochs}")

    start_time = time.time()
    objective = task.loss_fn.objective
    for ep in range(start_epoch, num_epochs):
        ep_start = time.time()
        model.train()
        # Per-step losses stay on the device: a float() here would make
        # the host wait for every step.
        ep_losses_dev = []
        rng = np.random.default_rng(seed * 1_000_003 + ep)
        for step, host in enumerate(batches(arrays, batch_size, shuffle=True, rng=rng)):
            draws = task.step_draws(seed, global_step, device)
            scores = train_step(task, optimizer, scheduler, to_device(host, device), draws)
            ep_losses_dev.append(scores[objective])
            global_step += 1
            if global_step % log_interval == 0:
                info = dict(ep=ep, step=step, mse=f"{float(scores['mse']):.3e}")
                if objective != "mse":
                    info[objective] = f"{float(scores[objective]):.3e}"
                info.update(lr=f"{lr_schedule(global_step - 1):.3e}",
                            time=round(time.time() - start_time))
                print(info)
        ep_losses = torch.stack(ep_losses_dev).tolist() if ep_losses_dev else []

        if measure_time:
            _print_memory(device)
            print("Time usage:")
            print(time.time() - ep_start)
            return ep_losses

        train_losses += ep_losses
        if (ep + 1) % eval_interval == 0:
            ckpt_dir = output_dir / f"ckpt-{ep}"
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            dev_scores = evaluate(task, dev_data, ckpt_dir, device=device,
                                  batch_size=eval_batch_size, collect_preds=False,
                                  max_eval_batches=eval_max_batches)["scores"]
            if plot_examples:
                # The train-time example.png (src/train_auto.py:234-250).
                pb = next(batches(dataset_arrays(dev_data), eval_batch_size, shuffle=False))
                b = to_device(pb, device)
                with torch.no_grad():
                    pred = task.predict_frame(b["inputs"], b["case_params"], b["mask"])
                plot_example(inp=pb["inputs"][0, ..., 0], label=pb["labels"][0, ..., 0],
                             pred=pred[0, ..., 0].cpu().numpy(),
                             out_path=output_dir / "example.png")
            dump_json(dev_scores, ckpt_dir / "dev_scores.json")
            dump_json(ep_losses, ckpt_dir / "train_loss.json")
            dev_key = "nmse" if "nmse" in dev_scores["all"] else objective
            checkpoints.save_checkpoint(
                model.state_dict(), ckpt_dir, ep=ep, train_loss=float(np.mean(ep_losses)),
                dev_loss=float(np.mean(dev_scores["all"][dev_key])),
                time=time.time() - ep_start)
            checkpoints.save_training_state(output_dir, model, optimizer, scheduler,
                                            global_step)
            # Losses before meta: training_meta.json commits the
            # snapshot, so a kill between the two writes leaves the
            # history at or ahead of the commit, never behind it (resume
            # truncates any overshoot).
            dump_json(train_losses, output_dir / "train_losses.json")
            dump_json(dict(epoch=ep, global_step=global_step),
                      output_dir / "training_meta.json")
    print("====== Training done ======")
    dump_json(train_losses, output_dir / "train_losses.json")
    plot_loss(train_losses, output_dir / "train_losses.png")
    return train_losses


def test(
    task: AutoTask,
    data: AutoDataset,
    output_dir: Path,
    *,
    device: torch.device,
    batch_size: int = 1,
    plot_interval: int = 10,
) -> None:
    """Single-step test-set eval; writes ``preds.npy`` and
    ``scores.json`` (the reference writes ``preds.pt``,
    ``src/train_auto.py:151-178``)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    result = evaluate(task, data, output_dir, device=device, batch_size=batch_size,
                      plot_interval=plot_interval)
    if result.get("preds") is not None:
        np.save(output_dir / "preds.npy", result["preds"])
    dump_json(result["scores"], output_dir / "scores.json")
