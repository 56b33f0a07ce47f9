"""Checkpoints in the result-dir layout (port of
``cfdbench_tpu/training/checkpoints.py``, without Orbax).

One ``ckpt-{ep}/`` directory per eval epoch holds ``scores.json``
(``{ep, train_loss, dev_loss, time}``) and the weights as
``model.pt``, a ``state_dict`` — the upstream CFDBench file name, and
what ``main_multistep`` reads. The best checkpoint is the one with the
lowest ``dev_loss``. ``training_state/model.pt`` is the trainer's
full-state snapshot for ``--resume``: parameters, the optimizer's state
(Adam's moments, or Adafactor's step and factored statistics), the step
and the schedule's position. Under tensor or pipeline parallelism a
rank holds a slice of the model; every rank gathers the one-process layout
(the ``layout``: ``parallel/tensor.py::ShardedLayout`` or
``parallel/pipeline.py::PipelineStage``) and rank 0 writes it, so a
snapshot resumes on any mesh.

Saves are crash-safe: the new file is written beside the old one, the
old one is kept as ``backup_model.pt``, and only then the new one takes
its name; :func:`load_params` falls back to the backup when ``model.pt``
is missing or unreadable.

A ``ckpt-*`` that holds only the JAX package's weights (an Orbax
``model/`` directory or ``model.msgpack``) is refused with the command
that converts it: ``scripts/export_torch_checkpoint.py``; so is a
``model.pt`` that the reference CFDBench wrote for an FNO, whose complex
and 1x1-conv weights the port lays out otherwise:
``scripts/import_reference_checkpoint_torch.py``.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..data.core import dump_json, load_json
from ..utils.torch_import import reference_only_keys
from .optim import state_shard_axis

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
    obj = torch.load(path, map_location="cpu", weights_only=True)
    keys = reference_only_keys(obj) if isinstance(obj, dict) else []
    if keys:
        raise ValueError(
            f"{path} is a reference CFDBench checkpoint ({', '.join(keys[:3])}, ...); "
            f"import it with `python scripts/import_reference_checkpoint_torch.py "
            f"--torch_ckpt {path}` and the same flags")
    return obj


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


def _is_moment(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dim() > 0


def _convert_state(optimizer, layout, state: Dict[str, dict], names, to_std: bool) -> dict:
    """Per-parameter optimizer state by name → the other layout's: each
    tensor entry through ``layout`` along the axis it is split on, the
    scalars (step counts, alike for every parameter) copied."""
    out = {n: {} for n in names}
    keys = sorted({k for st in state.values() for k, v in st.items() if _is_moment(v)})
    for k in keys:
        named = {n: st[k] for n, st in state.items() if k in st}
        axes = {n: None if layout.shard_axis(n) is None else state_shard_axis(
            optimizer, k, layout.whole_shape(n), layout.shard_axis(n)) for n in named}
        moved = layout.to_std(named, axes) if to_std else layout.from_std(named, axes)
        for n, t in moved.items():
            out[n][k] = t
    first = next(iter(state.values()), {})
    for n in names:
        for k, v in state.get(n, first).items():
            if not _is_moment(v):  # a copy each: Adam steps its count in place
                out[n][k] = v.clone() if isinstance(v, torch.Tensor) else v
    return out


def _convert_flat(sd: dict, keys, convert) -> dict:
    """``sd`` with its ``keys`` entries (vectors of the parameters laid end
    to end) through ``convert``."""
    return dict(sd, state={i: {k: convert(v) if k in keys else v for k, v in st.items()}
                           for i, st in sd["state"].items()})


def optimizer_to_std(optimizer: torch.optim.Optimizer, layout) -> dict:
    """The optimizer's ``state_dict`` in the one-process layout (the
    parameters in the one-process model's order); a collective over the
    model ranks. With no ``layout``, the ``state_dict`` itself. An
    optimizer whose state holds flat vectors of all its parameters
    (``FLAT``, ``optim.GenCastAdamW``) has them through
    ``layout.flat_to_std``."""
    sd = optimizer.state_dict()
    if layout is None:
        return sd
    if hasattr(optimizer, "FLAT"):
        return _convert_flat(sd, optimizer.FLAT, layout.flat_to_std)
    (group,) = sd["param_groups"]
    state = {layout.local_names[i]: st for i, st in sd["state"].items()}
    std = _convert_state(optimizer, layout, state, layout.std_names, True)
    return dict(state={i: std[n] for i, n in enumerate(layout.std_names) if std[n]},
                param_groups=[dict(group, params=list(range(len(layout.std_names))))])


def optimizer_from_std(sd: dict, optimizer: torch.optim.Optimizer, layout) -> None:
    """Load a one-process ``state_dict`` (:func:`optimizer_to_std`) into
    this rank's optimizer (with no ``layout``, as it is)."""
    if layout is None:
        optimizer.load_state_dict(sd)
        return
    if hasattr(optimizer, "FLAT"):
        optimizer.load_state_dict(_convert_flat(sd, optimizer.FLAT, layout.flat_from_std))
        return
    (group,) = sd["param_groups"]
    state = {layout.std_names[i]: st for i, st in sd["state"].items()}
    local = _convert_state(optimizer, layout, state, layout.local_names, False)
    optimizer.load_state_dict(dict(
        state={i: local[n] for i, n in enumerate(layout.local_names) if local[n]},
        param_groups=[dict(group, params=list(range(len(layout.local_names))))]))


def save_training_state(output_dir: Path, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, scheduler, step: int,
                        layout=None, write: bool = True) -> Path:
    """The full state ``--resume`` restores, under ``training_state/``. With
    a ``layout`` (``model`` the module the optimizer trains) every rank
    gathers the one-process layout and only a rank with ``write`` saves."""
    params, opt = model.state_dict(), optimizer.state_dict()
    if layout is not None:
        params, opt = layout.to_std(params), optimizer_to_std(optimizer, layout)
    path = Path(output_dir) / STATE_DIR
    if write:
        save_params(dict(params=params, optimizer=opt, scheduler=scheduler.state_dict(),
                         step=step), path)
    return path


def load_training_state(output_dir: Path, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, scheduler, layout=None) -> int:
    """Restore what :func:`save_training_state` wrote into ``model``,
    ``optimizer`` and ``scheduler``, this rank's slice of it under a
    ``layout``; returns the step."""
    state = load_params(Path(output_dir) / STATE_DIR)
    if layout is None:
        model.load_state_dict(state["params"])
        optimizer.load_state_dict(state["optimizer"])
    else:
        model.load_state_dict(layout.from_std(state["params"]))
        optimizer_from_std(state["optimizer"], optimizer, layout)
    scheduler.load_state_dict(state["scheduler"])
    return state["step"]
