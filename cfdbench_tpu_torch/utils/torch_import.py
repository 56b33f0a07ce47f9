"""Import reference CFDBench checkpoints (``model.pt`` state dicts) into
the port (port of ``cfdbench_tpu/utils/torch_import.py``).

The reference's trainers save ``model.state_dict()`` into
``ckpt-{ep}/model.pt`` (``src/train_auto.py:294-301``,
``src/train.py:222-245``). The port's modules carry the reference's
parameter names (``utils/flax_import.py``), so an import is a few
relayouts:

- the FNO (``src/models/fno/fno2d.py:54-58, 115-233``): the 1x1
  convolutions ``fc0``, ``fc1``, ``fc2`` and ``blocks.{i}.w0``, weights
  ``(O, I, 1, 1)``, are ``Linear`` weights ``(O, I)`` here; the complex
  spectral weights ``blocks.{i}.conv0.weights1`` and ``weights2`` ``(I, O,
  m1, m2)``, one per low-frequency corner, are the real-pair
  ``blocks.{i}.weights`` ``(corner, re/im, I, O, m1, m2)``
  (``ops/spectral.py``);
- the ResNet: the BatchNorms that the reference defines and never calls
  (``src/models/resnet.py:40-56``) are dropped, every module that holds
  running statistics with its parameters;
- a BatchNorm saved without ``num_batches_tracked`` gets 0;
- the U-Net, the four point models, the FFN and the DeepONet load as
  they are.

:func:`verify_state_dict` holds the result to a freshly built port
model's ``state_dict``, naming every missing, unexpected or misshapen
key; ``scripts/import_reference_checkpoint_torch.py`` does both and
writes the port's ``ckpt-{ep}/``. :func:`to_reference` is the inverse
relayout.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]
FAMILIES = ("fno", "unet", "resnet", "auto_ffn", "auto_deeponet", "auto_edeeponet",
            "auto_deeponet_cnn", "ffn", "deeponet")
_CORNER = re.compile(r"blocks\.(\d+)\.conv0\.weights([12])")
_SPECTRAL = re.compile(r"blocks\.(\d+)\.weights")


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def reference_only_keys(sd: Mapping) -> list:
    """The keys of ``sd`` that only the reference's FNO layout has: its
    complex corner weights and its 4-D 1x1-conv weights."""
    return sorted(k for k, v in sd.items() if isinstance(k, str) and (
        _CORNER.fullmatch(k) or (k in ("fc0.weight", "fc1.weight", "fc2.weight")
                                 and getattr(v, "ndim", 0) == 4)))


def _import_fno(sd: StateDict) -> StateDict:
    out = {k: v[:, :, 0, 0] if v.dim() == 4 and v.shape[2:] == (1, 1) else v
           for k, v in sd.items() if not _CORNER.fullmatch(k)}
    blocks = sorted({int(m.group(1)) for k in sd if (m := _CORNER.fullmatch(k))})
    if not blocks:
        raise KeyError("no 'blocks.{i}.conv0.weights1' keys: not a reference FNO state dict")
    for i in blocks:
        corners = [sd[f"blocks.{i}.conv0.weights{c}"] for c in (1, 2)]
        out[f"blocks.{i}.weights"] = torch.stack([torch.stack([w.real, w.imag])
                                                  for w in corners])
    return out


def _drop_batch_norms(sd: StateDict) -> StateDict:
    norms = {k[:-len("running_mean")] for k in sd if k.endswith(".running_mean")}
    return {k: v for k, v in sd.items() if not k.startswith(tuple(norms))}


def import_state_dict(model_name: str, sd: Mapping) -> StateDict:
    """A reference ``state_dict`` of ``model_name`` (tensors or numpy
    arrays) → the port model's, float32 tensors on the host."""
    if model_name not in FAMILIES:
        raise ValueError(f"no reference importer for model '{model_name}' "
                         f"(supported: {sorted(FAMILIES)})")
    sd = {k: _tensor(v) for k, v in sd.items()}
    if model_name == "fno":
        sd = _import_fno(sd)
    elif model_name == "resnet":
        sd = _drop_batch_norms(sd)
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd.setdefault(k[:-len("running_mean")] + "num_batches_tracked",
                      torch.tensor(0, dtype=torch.long))
    return {k: v if v.dtype == torch.long else v.float().contiguous() for k, v in sd.items()}


def to_reference(model_name: str, sd: Mapping) -> StateDict:
    """The port's ``state_dict`` in the reference's layout: the inverse of
    :func:`import_state_dict` for the FNO (complex corner weights, 4-D
    1x1-conv weights); the other families' keys are the reference's."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    if model_name != "fno":
        return sd
    out = {}
    for k, v in sd.items():
        m = _SPECTRAL.fullmatch(k)
        if m:
            for c in (0, 1):
                out[f"blocks.{m.group(1)}.conv0.weights{c + 1}"] = torch.complex(v[c, 0], v[c, 1])
        elif k.endswith(".weight") and v.dim() == 2:
            out[k] = v[:, :, None, None]
        else:
            out[k] = v
    return out


def verify_state_dict(imported: Mapping, template: Mapping) -> None:
    """Raise ``ValueError`` naming every key of ``template`` (a freshly
    built port model's ``state_dict``) that ``imported`` lacks, every key
    it has beyond them, and every shape that differs."""
    problems = []
    for k in sorted(set(imported) | set(template)):
        if k not in imported:
            problems.append(f"missing in import: {k} {tuple(template[k].shape)}")
        elif k not in template:
            problems.append(f"unexpected in import: {k} {tuple(imported[k].shape)}")
        elif tuple(imported[k].shape) != tuple(template[k].shape):
            problems.append(f"shape mismatch at {k}: imported {tuple(imported[k].shape)} "
                            f"vs model {tuple(template[k].shape)}")
    if problems:
        raise ValueError("imported checkpoint does not match the model:\n  "
                         + "\n  ".join(problems))
