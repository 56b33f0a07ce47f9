"""GenCast trainer (port of ``cfdbench_tpu/training/trainer_gencast.py``,
the reference's ``src/train_gencast.py``).

- :func:`train_gencast`: AdamW with a warmup-cosine schedule, global-norm
  clipping, gradient accumulation and non-finite skipping as one optimizer
  step (``optim.GenCastAdamW``); per-step mse and gradient-norm logs; every
  ``eval_interval`` epochs the dev split's noise-prediction scores beside
  the masked persistence baseline (``input_*``) and, on the first
  ``FRAME_EVAL_BATCHES`` batches, the scores of generated frames
  (``gen_frame_*``), into ``ckpt-{ep}/dev_scores.json``; ``best_model/``
  on the lowest dev nmse; the full ``training_state/`` and
  ``training_meta.json``, from which a later run resumes.
- :func:`test_gencast`: every next frame of a split generated and scored,
  masked, beside the persistence baseline; ``scores.json`` and
  ``preds.npy``.

Train step ``step``'s draws are keyed ``train_key(seed + 4242, step)``, the JAX
trainer's ``fold_in(fast_train_key(seed + 4242), step)`` (``utils/rng.py``),
counted in micro-batches; evaluation draws from the fixed evaluation key.
Scores stay on the device until one transfer per evaluation.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..data.core import dump_json, load_json
from ..data.pipeline import batches, num_batches, to_device
from ..data.wrapper import GenCastDataset
from ..models.diffusion import GenCastCfdModel
from ..utils.rng import train_key
from . import checkpoints
from .optim import global_norm, make_gencast_tx

BEST_DIR = "best_model"
# The JAX trainer's offset of its training key from the seed.
TRAIN_KEY_OFFSET = 4242
# The JAX trainer's defaults, which its entry point keeps: the schedule's
# warmup in optimizer steps, and the dev batches whose frames are generated.
WARMUP_STEPS = 500
FRAME_EVAL_BATCHES = 4


def dataset_arrays(data: GenCastDataset) -> Dict[str, np.ndarray]:
    return dict(inputs=data.inputs, inputs_prev=data.inputs_prev, labels=data.labels,
                mask=data.masks, case_params=data.case_params)


@torch.no_grad()
def eval_step(task: GenCastCfdModel, batch):
    """``(2, n_names)``: the noise-prediction scores from the evaluation
    key, and the masked persistence baseline
    (``src/train_gencast.py:176-180``)."""
    names = task.loss_fn.get_score_names()
    _, scores = task.loss_scores(batch)
    input_scores = task.loss_fn(batch["inputs"] * batch["mask"], batch["labels"] * batch["mask"],
                                sample_weights=batch.get("weights"))
    return torch.stack([torch.stack([scores[k] for k in names]),
                        torch.stack([input_scores[k] for k in names])])


@torch.no_grad()
def frame_eval_step(task: GenCastCfdModel, batch):
    """``(scores (2, n_names), frame)``: the generated frame's masked
    scores against the label, and the persistence baseline."""
    names = task.loss_fn.get_score_names()
    frame = task.generate(batch["inputs"], batch["inputs_prev"], batch["case_params"],
                          batch["mask"])
    w = batch.get("weights")
    labels = batch["labels"] * batch["mask"]
    scores = task.loss_fn(frame * batch["mask"], labels, sample_weights=w)
    input_scores = task.loss_fn(batch["inputs"] * batch["mask"], labels, sample_weights=w)
    return torch.stack([torch.stack([scores[k] for k in names]),
                        torch.stack([input_scores[k] for k in names])]), frame


def train_gencast(
    task: GenCastCfdModel,
    train_data: GenCastDataset,
    dev_data: GenCastDataset,
    output_dir: Path,
    *,
    device: torch.device,
    num_epochs: int = 100,
    lr: float = 1e-4,
    batch_size: int = 8,
    eval_batch_size: int = 16,
    eval_interval: int = 2,
    log_interval: int = 50,
    weight_decay: float = 1e-5,
    grad_accum_steps: int = 1,
    seed: int = 0,
    max_eval_batches: int = 100,
) -> int:
    """Train ``task.model`` in place; returns the number of micro-steps
    taken. A run continues from ``training_state/`` and
    ``training_meta.json`` when both exist, as the JAX package's does."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    model = task.model
    steps_per_epoch = num_batches(len(train_data), batch_size)
    opt = make_gencast_tx(model.parameters(), lr, total_steps=steps_per_epoch * num_epochs,
                          warmup_steps=WARMUP_STEPS, weight_decay=weight_decay,
                          grad_accum_steps=grad_accum_steps)
    arrays = dataset_arrays(train_data)
    names = task.loss_fn.get_score_names()

    start_epoch, step, best_nmse = 0, 0, np.inf
    meta_path = output_dir / "training_meta.json"
    state_dir = output_dir / checkpoints.STATE_DIR
    if meta_path.exists() and state_dir.exists():
        meta = load_json(meta_path)
        state = checkpoints.load_params(state_dir)
        model.load_state_dict(state["params"])
        opt.load_state_dict(state["optimizer"])
        step = state["step"]
        start_epoch, best_nmse = meta["epoch"] + 1, meta["best_nmse"]
        print(f"Resumed from epoch {meta['epoch']} (best {best_nmse:.4e})")

    print(f"GenCast model has {sum(p.numel() for p in model.parameters())} parameters")
    start = time.time()
    for ep in range(start_epoch, num_epochs):
        model.train()
        rng = np.random.default_rng(seed * 104729 + ep)
        for i, host in enumerate(batches(arrays, batch_size, shuffle=True, rng=rng)):
            opt.zero_grad(set_to_none=True)
            loss, scores = task.loss_scores(to_device(host, device),
                                            train_key(seed + TRAIN_KEY_OFFSET, step))
            loss.backward()
            if (i + 1) % log_interval == 0:
                gnorm = global_norm([p.grad for p in model.parameters()])
            opt.step()
            step += 1
            if (i + 1) % log_interval == 0:
                print(dict(ep=ep, step=i, mse=f"{float(scores['mse']):.3e}",
                           grad_norm=f"{float(gnorm):.2f}", time=round(time.time() - start)))
        if (ep + 1) % eval_interval != 0:
            continue
        model.eval()
        rows, frame_rows = [], []
        for i, host in enumerate(batches(dataset_arrays(dev_data), eval_batch_size,
                                         shuffle=False)):
            if max_eval_batches and i >= max_eval_batches:
                break
            batch = to_device(host, device)
            rows.append(eval_step(task, batch))
            if i < FRAME_EVAL_BATCHES:
                frame_rows.append(frame_eval_step(task, batch)[0][0])
        # One transfer for every score; an empty dev split gives nan means.
        mat = torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 2, len(names)))
        key = "nmse" if "nmse" in names else task.loss_fn.objective
        dev_nmse = float(mat[:, 0, names.index(key)].mean())
        dev_scores = {"mean": {}, "all": {}}
        for j, k in enumerate(names):
            dev_scores["mean"][k] = float(mat[:, 0, j].mean())
            dev_scores["mean"][f"input_{k}"] = float(mat[:, 1, j].mean())
            dev_scores["all"][k] = mat[:, 0, j].tolist()
        if frame_rows:
            fmat = torch.stack(frame_rows).cpu().numpy()
            for j, k in enumerate(names):
                dev_scores["mean"][f"gen_frame_{k}"] = float(fmat[:, j].mean())
            print(f"ep {ep}: generated-frame nmse = "
                  f"{dev_scores['mean'].get('gen_frame_nmse'):.4e} ({len(frame_rows)} batches)")
        ckpt_dir = output_dir / f"ckpt-{ep}"
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        dump_json(dev_scores, ckpt_dir / "dev_scores.json")
        print(f"ep {ep}: dev nmse = {dev_nmse:.4e}")
        if dev_nmse < best_nmse:
            best_nmse = dev_nmse
            checkpoints.save_params(model.state_dict(), output_dir / BEST_DIR)
            print("  new best saved")
        checkpoints.save_params(dict(params=model.state_dict(), optimizer=opt.state_dict(),
                                     step=step), state_dir)
        dump_json(dict(epoch=ep, best_nmse=best_nmse, dev_nmse=dev_nmse), meta_path)
    return step


def test_gencast(task: GenCastCfdModel, data: GenCastDataset, output_dir: Path, *,
                 device: torch.device, batch_size: int = 16) -> dict:
    """Generate and score every next frame of ``data``; writes
    ``scores.json`` and ``preds.npy``, the schema of the other trainers'
    test mode."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    names = task.loss_fn.get_score_names()
    task.model.eval()
    rows, frames, n_valids = [], [], []
    for host in batches(dataset_arrays(data), batch_size, shuffle=False):
        row, frame = frame_eval_step(task, to_device(host, device))
        rows.append(row)
        frames.append(frame)
        n_valids.append(int(host["weights"].sum()))
    mat = torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 2, len(names)))
    scores = {"mean": {}, "all": {}}
    for j, k in enumerate(names):
        scores["mean"][k] = float(mat[:, 0, j].mean())
        scores["mean"][f"input_{k}"] = float(mat[:, 1, j].mean())
        scores["all"][k] = mat[:, 0, j].tolist()
    dump_json(scores, output_dir / "scores.json")
    preds = (np.concatenate([f.cpu().numpy()[:nv] for f, nv in zip(frames, n_valids)])
             if frames else np.zeros((0,)))
    np.save(output_dir / "preds.npy", preds)
    return scores
