"""Checkpoints in the result-dir layout (port of
``cfdbench_tpu/training/checkpoints.py``, without Orbax).

One ``ckpt-{ep}/`` directory per eval epoch holds ``scores.json``
(``{ep, train_loss, dev_loss, time}``) and the weights as
``model.pt``, a ``state_dict`` — the upstream CFDBench file name. The
best checkpoint is the one with the lowest ``dev_loss``.

A ``ckpt-*`` that holds only the JAX package's weights (an Orbax
``model/`` directory or ``model.msgpack``) is refused with the command
that converts it: ``scripts/export_torch_checkpoint.py``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import torch

from ..data.core import dump_json, load_json

MODEL_FILE = "model.pt"
JAX_WEIGHTS = ("model", "backup_model", "model.msgpack")


def save_params(state_dict: Dict[str, torch.Tensor], ckpt_dir: Path) -> Path:
    """Write ``ckpt_dir/model.pt`` through a temp file and an atomic
    rename, so a kill mid-write leaves no partial checkpoint."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    target = ckpt_dir / MODEL_FILE
    tmp = ckpt_dir / (MODEL_FILE + ".tmp")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, target)
    return target


def save_checkpoint(state_dict: Dict[str, torch.Tensor], ckpt_dir: Path, *,
                    ep: int, dev_loss: float, train_loss: float = 0.0,
                    time: float = 0.0) -> Path:
    """``save_params`` and the ``scores.json`` beside it that
    ``get_best_ckpt`` ranks by, as the trainer writes them."""
    path = save_params(state_dict, ckpt_dir)
    dump_json(dict(ep=ep, train_loss=train_loss, dev_loss=dev_loss, time=time),
              Path(ckpt_dir) / "scores.json")
    return path


def get_best_ckpt(output_dir: Path) -> Optional[Path]:
    """The ``ckpt-*`` directory with the lowest ``dev_loss``."""
    best_loss, best_dir = float("inf"), None
    for ckpt_dir in sorted(Path(output_dir).glob("ckpt-*")):
        scores_file = ckpt_dir / "scores.json"
        if not scores_file.exists():
            continue
        dev_loss = load_json(scores_file)["dev_loss"]
        if dev_loss < best_loss:
            best_loss, best_dir = dev_loss, ckpt_dir
    return best_dir


def load_params(ckpt_dir: Path) -> Dict[str, torch.Tensor]:
    ckpt_dir = Path(ckpt_dir)
    path = ckpt_dir / MODEL_FILE
    if not path.exists():
        jax_files = [n for n in JAX_WEIGHTS if (ckpt_dir / n).exists()]
        if jax_files:
            raise FileNotFoundError(
                f"{ckpt_dir} holds JAX weights ({', '.join(jax_files)}) but "
                f"no {MODEL_FILE}; convert them with `python "
                "scripts/export_torch_checkpoint.py` and the same flags"
            )
        raise FileNotFoundError(f"no {MODEL_FILE} under {ckpt_dir}")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_best_params(output_dir: Path) -> Dict[str, torch.Tensor]:
    best = get_best_ckpt(output_dir)
    if best is None:
        raise FileNotFoundError(f"no ckpt-*/scores.json under {output_dir}")
    return load_params(best)
