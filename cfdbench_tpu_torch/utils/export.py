"""Serving export: a model's next-frame function or its whole rollout as
a ``torch.export`` program (port of ``cfdbench_tpu/utils/export.py``).

- :func:`export_predict` — ``f(frame, case_params, mask) -> frame``,
  ``(B, H, W, C)`` (streaming serving). The frame has the channels the
  rollout feeds back (``task.feedback_channels``: 1 for the point
  models), except the AutoDeepONetCnn's, which has no rollout and takes
  the 2-channel frame it was built on; the JAX package traces it on 1
  channel and fails (ROADMAP.md C).
- :func:`export_rollout` — ``steps`` self-fed predictions as one
  program, ``(steps, B, H, W, C)`` (batch inference), as the JAX
  artifact's rollout computes them: every frame a prediction, for the
  ResNet too.
- :func:`load_exported` — the artifact as a callable.

The program is traced with the model in eval mode (the U-Net's BatchNorm
reads its running statistics, which ride along as buffers) under
``torch.no_grad`` and written with ``torch.export.save`` to a ``.pt2``
file, weights included. Shapes are static: export one artifact per
serving batch, as in the JAX package.

A served program needs ``torch`` and the port's operator registrations,
``cfdbench_tpu_torch::fno_block`` and ``fno_head``, which importing this
module (or ``ops/fno_kernels.py``) makes: the FNO's two hand-written
kernels are nodes of its graph, and each launch is counted as in process
(``fno_kernels.launch_counts``). It needs no model class and no
checkpoint.

An artifact runs on the device it was exported for, which it records;
loading it for another device, or calling it on tensors that lie
elsewhere, raises. Nothing is moved. The diffusion models are refused:
their noise comes from keyed ``torch.Generator`` draws (``utils/rng.py``),
which ``torch.export`` does not trace (ROADMAP.md A14b).
"""

from __future__ import annotations

import zipfile
from pathlib import Path

import torch
from torch import nn

from ..ops import fno_kernels  # noqa: F401  (registers the kernels' operators)
from ..training.rollout import unroll
from .device import require_cuda

DEVICE_RECORD = "device"  # the artifact's extra file that names its device


class _Served(nn.Module):
    """``task.predict_frame`` or, with ``steps``, its self-fed rollout, as
    a module whose parameters and buffers are the model's."""

    def __init__(self, task, steps=None):
        super().__init__()
        self.model = task.model
        self.predict = task.predict_frame
        self.steps = steps

    def forward(self, frame, case_params, mask):
        if self.steps is None:
            return self.predict(frame, case_params, mask)
        return unroll(lambda f, c, m, i: self.predict(f, c, m), frame, case_params, mask,
                      self.steps)


def _device(device) -> torch.device:
    """``device`` with a CUDA index filled in; the card when None."""
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return require_cuda()
    return device


def _export(task, path: Path, batch: int, height: int, width: int, n_case_params: int,
            channels: int, steps, device) -> int:
    if getattr(task, "generative", False):
        raise NotImplementedError(
            f"{type(task).__name__}: a diffusion model's export is not ported; its noise "
            "comes from keyed torch.Generator draws, which torch.export does not trace "
            "(ROADMAP.md A14b)")
    device = _device(device)
    model = task.model
    elsewhere = {str(t.device) for t in [*model.parameters(), *model.buffers()]} - {str(device)}
    if elsewhere:
        raise ValueError(f"the model lies on {sorted(elsewhere)}, not on {device}, the device "
                         "to export for")
    shape = (batch, height, width)
    args = (torch.zeros((*shape, channels), device=device),
            torch.zeros((batch, n_case_params), device=device),
            torch.ones((*shape, 1), device=device))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(_Served(task, steps), args, strict=False)
    finally:
        model.train(was_training)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, path, extra_files={DEVICE_RECORD: str(device)})
    return path.stat().st_size


def export_predict(task, path: Path, batch: int, height: int, width: int,
                   n_case_params: int, device=None) -> int:
    """Write ``task.predict_frame`` at these shapes, weights included, to
    ``path`` (``.pt2``) for ``device`` (the card when None; the model
    must lie there). Returns the artifact's size in bytes."""
    from ..models.point import AutoDeepONetCnn

    channels = (task.model.in_chan if isinstance(task.model, AutoDeepONetCnn)
                else task.feedback_channels)
    return _export(task, path, batch, height, width, n_case_params, channels, None, device)


def export_rollout(task, path: Path, batch: int, height: int, width: int,
                   n_case_params: int, steps: int = 20, device=None) -> int:
    """Write the ``steps``-step self-fed rollout of ``task.predict_frame``
    to ``path``; as :func:`export_predict`. An AutoDeepONetCnn has no
    rollout, and is refused by name."""
    from ..models.point import NO_ROLLOUT, AutoDeepONetCnn

    if isinstance(task.model, AutoDeepONetCnn):
        raise ValueError(NO_ROLLOUT)
    return _export(task, path, batch, height, width, n_case_params, task.feedback_channels,
                   steps, device)


def artifact_device(path: Path) -> torch.device:
    """The device an artifact was exported for, read without loading it."""
    with zipfile.ZipFile(path) as archive:
        # torch.export.save keeps extra files under extra/ (extra_files/ in
        # older releases).
        names = [n for n in archive.namelist()
                 if n.split("/")[-2:] in (["extra", DEVICE_RECORD], ["extra_files", DEVICE_RECORD])]
        if not names:
            raise ValueError(f"{path} records no device: it was not written by "
                             "export_predict or export_rollout")
        return torch.device(archive.read(names[0]).decode())


class ServedProgram:
    """A loaded artifact: ``served(frame, case_params, mask)`` runs it.
    ``program`` is the ``ExportedProgram`` (its graph, its inputs'
    shapes), ``device`` the device it runs on."""

    def __init__(self, program, device: torch.device):
        self.program, self.device = program, device
        self.module = program.module()

    @property
    def input_shapes(self):
        """The shapes of ``(frame, case_params, mask)``."""
        user = set(self.program.graph_signature.user_inputs)
        return [tuple(n.meta["val"].shape) for n in self.program.graph.nodes
                if n.op == "placeholder" and n.name in user]

    def __call__(self, frame, case_params, mask):
        for name, t in (("frame", frame), ("case_params", case_params), ("mask", mask)):
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}; the artifact runs on {self.device}, "
                                 "where it was exported")
        return self.module(frame, case_params, mask)


def load_exported(path: Path, device=None) -> ServedProgram:
    """Load an artifact of :func:`export_predict` or :func:`export_rollout`
    to run on the device it was exported for. ``device``, when given,
    must be that device: an artifact is not moved."""
    exported_for = artifact_device(path)
    if device is not None:
        want = torch.device(device)
        if want.type != exported_for.type or want.index not in (None, exported_for.index):
            raise ValueError(f"{path} was exported for {exported_for} and runs there only, "
                             f"not on {want}")
    if exported_for.type == "cuda":
        require_cuda()
    return ServedProgram(torch.export.load(path), exported_for)
