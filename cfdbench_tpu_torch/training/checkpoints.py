"""Checkpoints in the result-dir layout (port of
``cfdbench_tpu/training/checkpoints.py``, without Orbax).

One ``ckpt-{ep}/`` directory per eval epoch holds ``scores.json``
(``{ep, train_loss, dev_loss, time}``) and the weights as
``model.pt``, a ``state_dict`` — the upstream CFDBench file name, and
what ``main_multistep`` reads. The best checkpoint is the one with the
lowest ``dev_loss``. ``training_state/model.pt`` is the trainer's
full-state snapshot for ``--resume``: parameters, both Adam moments, the
step and the schedule's position.

Saves are crash-safe: the new file is written beside the old one, the
old one is kept as ``backup_model.pt``, and only then the new one takes
its name; :func:`load_params` falls back to the backup when ``model.pt``
is missing or unreadable.

A ``ckpt-*`` that holds only the JAX package's weights (an Orbax
``model/`` directory or ``model.msgpack``) is refused with the command
that converts it: ``scripts/export_torch_checkpoint.py``.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..data.core import dump_json, load_json

MODEL_FILE = "model.pt"
BACKUP_FILE = "backup_model.pt"
STATE_DIR = "training_state"
JAX_WEIGHTS = ("model", "backup_model", "model.msgpack")


def _to_host(obj: Any) -> Any:
    """``obj`` with every tensor in its nest of dicts, lists and tuples
    replaced by a detached CPU copy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save_params(obj: Any, ckpt_dir: Path) -> Path:
    """Write ``obj`` (a ``state_dict``, or any nest of tensors and plain
    values) to ``ckpt_dir/model.pt`` with its tensors on the host, so a
    machine without a card loads it: into a temp file first, then the
    previous ``model.pt`` becomes ``backup_model.pt``, then the temp file
    takes its place, so a kill at any point leaves one whole copy."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    target = ckpt_dir / MODEL_FILE
    tmp = ckpt_dir / (MODEL_FILE + ".tmp")
    torch.save(_to_host(obj), tmp)
    if target.exists():
        os.replace(target, ckpt_dir / BACKUP_FILE)
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
    """The ``ckpt-*`` directory with the lowest ``dev_loss``
    (``src/utils/common.py:161-174``)."""
    best_loss, best_dir = float("inf"), None
    for ckpt_dir in sorted(Path(output_dir).glob("ckpt-*")):
        scores_file = ckpt_dir / "scores.json"
        if not scores_file.exists():
            continue
        dev_loss = load_json(scores_file)["dev_loss"]
        if dev_loss < best_loss:
            best_loss, best_dir = dev_loss, ckpt_dir
    return best_dir


def _load(path: Path) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_params(ckpt_dir: Path) -> Any:
    """What :func:`save_params` wrote under ``ckpt_dir``, on the host;
    ``backup_model.pt`` when ``model.pt`` is missing or cut short."""
    ckpt_dir = Path(ckpt_dir)
    path, backup = ckpt_dir / MODEL_FILE, ckpt_dir / BACKUP_FILE
    if path.exists():
        try:
            return _load(path)
        except (RuntimeError, EOFError, pickle.UnpicklingError) as err:
            if not backup.exists():
                raise
            print(f"[checkpoints] {path} failed to load ({err}); trying {BACKUP_FILE}, "
                  "the previous save")
            return _load(backup)
    if backup.exists():
        print(f"[checkpoints] {path} is absent; trying {BACKUP_FILE}, the previous save")
        return _load(backup)
    jax_files = [n for n in JAX_WEIGHTS if (ckpt_dir / n).exists()]
    if jax_files:
        raise FileNotFoundError(
            f"{ckpt_dir} holds JAX weights ({', '.join(jax_files)}) but "
            f"no {MODEL_FILE}; convert them with `python "
            "scripts/export_torch_checkpoint.py` and the same flags"
        )
    raise FileNotFoundError(f"no {MODEL_FILE} under {ckpt_dir}")


def load_best_params(output_dir: Path) -> Dict[str, torch.Tensor]:
    best = get_best_ckpt(output_dir)
    if best is None:
        raise FileNotFoundError(f"no ckpt-*/scores.json under {output_dir}")
    return load_params(best)


def save_training_state(output_dir: Path, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, scheduler, step: int) -> Path:
    """The full state ``--resume`` restores, under ``training_state/``."""
    return save_params(dict(params=model.state_dict(), optimizer=optimizer.state_dict(),
                            scheduler=scheduler.state_dict(), step=step),
                       Path(output_dir) / STATE_DIR)


def load_training_state(output_dir: Path, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, scheduler) -> int:
    """Restore what :func:`save_training_state` wrote into ``model``,
    ``optimizer`` and ``scheduler``; returns the step."""
    state = load_params(Path(output_dir) / STATE_DIR)
    model.load_state_dict(state["params"])
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    return state["step"]
