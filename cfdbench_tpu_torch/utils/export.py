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

The diffusion models (``pixel_diffusion`` and the latent models) serve
their DDPM sampler inside the program as one loop operator
(``torch.ops.higher_order.scan``, ``ops.diffusion.scan_loop``): the
graph holds the denoise step once, whatever the number of inference
steps, and the export raises rather than unroll it. The sampler's noise
is the program's fourth input, ``(S + 1, *sample)`` for a predict and
``(steps, S + 1, *sample)`` for a rollout (``task.noise_shape``), since
``torch.export`` does not trace the keyed ``torch.Generator`` draws
(``utils/rng.py``). The artifact records its sampler (``SAMPLER_RECORD``);
served without noise it draws on its device what the in-process call
draws: a predict from ``EVAL_KEY``, rollout step i from ``rollout_key(0,
i, steps)``, fresh noise each step as ``main_multistep`` draws it (the
JAX artifact's rollout repeats its ``PRNGKey(0)`` draws every step,
ROADMAP.md C). A latent model's frozen VAE rides in the artifact beside
its networks. GenCast, which has no ``predict_frame`` in either package,
and a task on a mesh are refused by name.

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
elsewhere, raises. Nothing is moved.
"""

from __future__ import annotations

import json
import zipfile
from pathlib import Path

import torch
from torch import nn

from ..ops import fno_kernels  # noqa: F401  (registers the kernels' operators)
from ..ops.diffusion import sampler_noise, scan_loop
from ..parallel.mesh import SINGLE
from ..training.rollout import unroll
from .device import require_cuda
from .rng import EVAL_KEY, rollout_key

DEVICE_RECORD = "device"  # the artifact's extra file that names its device
# A sampler artifact's extra file: its inference steps, its noise input's
# shape and kind ("predict" or "rollout").
SAMPLER_RECORD = "sampler"


class _Served(nn.Module):
    """``task.predict_frame`` or, with ``steps``, its self-fed rollout, as
    a module whose parameters and buffers are the model's (and a latent
    model's frozen VAE); a diffusion model's takes its sampler's noise,
    step i of a rollout its slice."""

    def __init__(self, task, steps=None):
        super().__init__()
        self.model = task.model
        if getattr(task, "generative", False):
            self.scheduler = task.scheduler  # its buffers: the sampler's step tables
            task.scheduler.step_tables(task.num_inference_steps,
                                       next(task.model.parameters()).device)
        if getattr(task, "vae", None) is not None:
            self.vae = task.vae
        self.predict = task.predict_frame
        self.steps = steps

    def forward(self, frame, case_params, mask, noise=None):
        if noise is None:
            if self.steps is None:
                return self.predict(frame, case_params, mask)
            return unroll(lambda f, c, m, i: self.predict(f, c, m), frame, case_params, mask,
                          self.steps)
        if self.steps is None:
            return self.predict(frame, case_params, mask, noise=noise)

        # A sampler's rollout is a loop over the frames, step i taking its
        # slice of the noise, whose body holds the sampler's loop: one trace
        # of the step, however many frames.
        def step(f, noise_i, c, m):
            f = self.predict(f, c, m, noise=noise_i).to(frame.dtype).contiguous()
            return f, f.clone()

        return scan_loop(step, frame, (noise,), self, (case_params, mask))[1]


def _device(device) -> torch.device:
    """``device`` with a CUDA index filled in; the card when None."""
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return require_cuda()
    return device


def graph_stats(program) -> dict:
    """``nodes``: the nodes of a program's graph and of the graphs its
    loop operators hold; ``loops``: its loop operators (``scan``) at each
    depth, ``[1]`` for a sampler, ``[1, 1]`` for a sampler's rollout (a
    loop over the frames that holds the sampler's), ``[]`` for the rest."""
    stats = dict(nodes=0, loops=[])

    def walk(module, depth):
        for node in module.graph.nodes:
            stats["nodes"] += 1
            if node.op == "call_function" and node.target is torch.ops.higher_order.scan:
                stats["loops"] += [0] * (depth + 1 - len(stats["loops"]))
                stats["loops"][depth] += 1
                walk(getattr(module, node.args[0].target), depth + 1)

    walk(program.graph_module, 0)
    return stats


def _export(task, path: Path, batch: int, height: int, width: int, n_case_params: int,
            channels: int, steps, device) -> int:
    if not hasattr(task, "predict_frame"):
        raise ValueError(f"{type(task).__name__} has no predict_frame (GenCast generates from "
                         "two frames), so it has no export, in the JAX package either "
                         "(ROADMAP.md C)")
    ranks = getattr(task, "mesh", SINGLE).world_size
    if ranks > 1:
        raise ValueError(f"{type(task).__name__} runs on a mesh of {ranks} ranks: an exported "
                         "program is one device's, as the JAX package declares its trace "
                         "single-device; export a task without use_mesh")
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
    extra = {DEVICE_RECORD: str(device)}
    sampler = getattr(task, "generative", False)
    if sampler:
        noise_shape = task.noise_shape(args[0].shape)
        if steps is not None:
            noise_shape = (steps, *noise_shape)
        args += (torch.zeros(noise_shape, device=device),)
        extra[SAMPLER_RECORD] = json.dumps(dict(
            kind="predict" if steps is None else "rollout", steps=task.num_inference_steps,
            noise_shape=noise_shape))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(_Served(task, steps), args, strict=False)
    except Exception as e:
        if not sampler:
            raise
        raise RuntimeError(f"{type(task).__name__}: the export of its DDPM sampler as one loop "
                           f"operator (torch.ops.higher_order.scan) failed on torch "
                           f"{torch.__version__}, as the cause says; the sampler is never "
                           "unrolled instead") from e
    finally:
        model.train(was_training)
    loops = graph_stats(program)["loops"]
    want = ([1] if steps is None else [1, 1]) if sampler else []
    if loops != want:
        raise RuntimeError(f"{type(task).__name__}: the exported graph holds loop operators "
                           f"{loops} by depth, not {want}")
    program.example_inputs = None  # zeros of the inputs' shapes: no part of the artifact
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, path, extra_files=extra)
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


def _extra_file(path: Path, name: str):
    """An extra file of an artifact, read without loading it; None when
    it has none of that name."""
    with zipfile.ZipFile(path) as archive:
        # torch.export.save keeps extra files under extra/ (extra_files/ in
        # older releases).
        names = [n for n in archive.namelist()
                 if n.split("/")[-2:] in (["extra", name], ["extra_files", name])]
        return archive.read(names[0]).decode() if names else None


def artifact_device(path: Path) -> torch.device:
    """The device an artifact was exported for, read without loading it."""
    device = _extra_file(path, DEVICE_RECORD)
    if device is None:
        raise ValueError(f"{path} records no device: it was not written by "
                         "export_predict or export_rollout")
    return torch.device(device)


class ServedProgram:
    """A loaded artifact: ``served(frame, case_params, mask)`` runs it, a
    sampler artifact's with ``noise=`` too. ``program`` is the
    ``ExportedProgram`` (its graph, its inputs' shapes), ``device`` the
    device it runs on, ``sampler`` a sampler artifact's record (None for
    the others)."""

    def __init__(self, program, device: torch.device, sampler=None):
        self.program, self.device, self.sampler = program, device, sampler
        self.module = program.module()

    @property
    def input_shapes(self):
        """The shapes of ``(frame, case_params, mask)``, and of a sampler
        artifact's noise."""
        user = set(self.program.graph_signature.user_inputs)
        return [tuple(n.meta["val"].shape) for n in self.program.graph.nodes
                if n.op == "placeholder" and n.name in user]

    def draw_noise(self) -> torch.Tensor:
        """The noise the in-process call draws: a predict's from
        ``EVAL_KEY``, rollout step i's from ``rollout_key(0, i, steps)``."""
        s = self.sampler
        if s["kind"] == "predict":
            return sampler_noise(EVAL_KEY, s["steps"], s["noise_shape"][1:], self.device)
        steps, _, *shape = s["noise_shape"]
        return torch.stack([sampler_noise(rollout_key(0, i, steps), s["steps"], shape,
                                          self.device) for i in range(steps)])

    def __call__(self, frame, case_params, mask, noise=None):
        if self.sampler is None:
            if noise is not None:
                raise ValueError("this artifact has no sampler: it takes no noise")
            args = (frame, case_params, mask)
        else:
            want = tuple(self.sampler["noise_shape"])
            if noise is None:
                noise = self.draw_noise()
            elif tuple(noise.shape) != want:
                raise ValueError(f"noise is {tuple(noise.shape)}; the artifact's sampler takes "
                                 f"{want}")
            args = (frame, case_params, mask, noise)
        for name, t in zip(("frame", "case_params", "mask", "noise"), args):
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}; the artifact runs on {self.device}, "
                                 "where it was exported")
        return self.module(*args)


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
    sampler = _extra_file(path, SAMPLER_RECORD)
    return ServedProgram(torch.export.load(path), exported_for,
                         None if sampler is None else json.loads(sampler))
