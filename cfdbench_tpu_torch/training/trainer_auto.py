"""Autoregressive trainer (port of
``cfdbench_tpu/training/trainer_auto.py``, the ``train_auto`` engine).

- :class:`AutoTask` couples a model with its loss. Field models (FNO,
  U-Net, ResNet): masked (B, H, W, C) predictions against mask-multiplied
  labels over all channels. Point models (the DeepONet family,
  ``pointwise``): (B, H*W) u predictions against the flattened u labels,
  unmasked; their rollout feeds back the 1-channel u frame. Losses in
  float32, with the batch's 0/1 sample weights. With ``compute_dtype``
  ``torch.bfloat16`` (``--use_mixed_precision``) the train forward runs on
  bfloat16 copies of the float32 parameters, the batch's inputs, case
  parameters and mask cast to bfloat16 (``models/common.py::cast_call``;
  a cast copy, not ``torch.autocast``, whose per-op casts and float32
  reductions are another computation than the JAX package's); the
  gradients come back to the float32 parameters through the casts, and
  the optimizer, the labels, the loss and evaluation stay float32.
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
- Data parallelism (:func:`use_mesh`, ``parallel/mesh.py``): every rank
  builds the same global batches, padded to a multiple of the rank count
  with weight-0 rows, and runs its block of rows; the loss and scores are
  the global batch's (``metrics.py``), the gradients are averaged over the
  ranks after the backward, the predictions gathered. Rank 0 writes every
  file and the others wait for it at a barrier; on ``--resume`` every
  rank loads the snapshot.
- Tensor and pipeline parallelism over the mesh's model axis
  (:func:`split_model`, for the length of :func:`train`, as the JAX
  trainer shards or packs its parameters after init and returns the
  one-process tree): tp splits the parameters by the JAX rules
  (``parallel/sharding_rules.py``; the FNO runs column- and row-parallel,
  ``models/fno.py``, every other model gathers at use,
  ``parallel/tensor.py``); pp (``--pp_microbatches``, the FNO alone)
  stages its blocks over the model ranks (``parallel/pipeline.py``), the
  global batch padded to a multiple of data ranks times microbatches.
  After the backward the replicated parameters that a rank uses in part
  (or, under pp, on one stage) have their gradients summed over the model
  ranks, then every gradient is averaged over the data ranks
  (:func:`reduce_gradients`). Evaluation, the checkpoints and the
  ``training_state/`` snapshot are in the one-process layout, gathered
  over the model ranks, so a run resumes on any mesh. A bfloat16 train
  forward (``compute_dtype``) runs the same split: the FNO's split blocks
  and head on their plain versions, a stage on bfloat16 copies of its
  parameters. :func:`split_module` is the gather-at-use split on its own,
  which the GenCast, VAE and DDPM trainers use.
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
from ..data.pipeline import batches, field_rows, num_batches, to_device
from ..metrics import LossFn
from ..models import fno
from ..models.common import cast_call
from ..models.diffusion import LatentDenoiser
from ..models.ffno import Ffno2d
from ..models.point import AutoDeepONet, AutoDeepONetCnn, AutoEDeepONet, AutoFfn
from ..models.punetg import PUNetGCFD
from ..models.resnet import ResNet
from ..models.unet import BatchNorm, UNet
from ..parallel.mesh import SINGLE, DataMesh
from ..parallel.pipeline import PipelineStage
from ..parallel import sharding_rules
from ..parallel.sharding_rules import shard_params
from ..parallel.spatial import gather_rows
from ..parallel.tensor import ShardedLayout, all_gather, gather_at_use
from ..utils.artifacts import plot_example, plot_loss, plot_predictions
from ..utils.rng import step_generator
from . import checkpoints
from .optim import make_adam, step_lr_schedule


class AutoTask:
    """Couples an autoregressive model with its loss and its rollout
    contract."""

    generative = False
    mesh = SINGLE  # the data axis (use_mesh)
    rows = None  # the model axis the grid rows split over (use_spatial)

    def __init__(self, model: nn.Module, loss_fn: Optional[LossFn] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.model = model
        self.loss_fn = loss_fn
        self.pointwise = getattr(model, "pointwise", False)
        self.compute_dtype = compute_dtype

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
        """``(loss, scores)`` of one train forward on ``batch``, in
        ``compute_dtype`` when one is set."""
        dt = self.compute_dtype
        if dt is None:
            out = self.forward(batch["inputs"], batch["case_params"], batch["mask"], generator)
        else:
            kwargs = {} if generator is None else dict(generator=generator)
            out = cast_call(self.model, dt, batch["inputs"].to(dt), batch["case_params"].to(dt),
                            batch["mask"].to(dt), **kwargs)
        s = self.scores(out, batch)
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


def use_mesh(task, mesh: DataMesh) -> None:
    """Run ``task`` (an :class:`AutoTask` or a diffusion task) on ``mesh``'s
    data axis: its scores reduce over the ranks, its draws are made over
    the global batch, and so are those of its modules that hold a
    ``mesh`` (BatchNorm's statistics, the ResNet's dropout)."""
    task.mesh = mesh
    if task.loss_fn is not None:
        task.loss_fn.mesh = mesh
    for module in task.model.modules():
        if hasattr(module, "mesh"):
            module.mesh = mesh


# The models that run on a rank's grid rows (--shard_spatial 1): every
# model of main_auto.
SPATIAL_MODELS = (fno.Fno2d, Ffno2d, UNet, ResNet, AutoFfn, AutoDeepONet, AutoEDeepONet,
                  AutoDeepONetCnn, PUNetGCFD, LatentDenoiser)


def use_spatial(task, axis) -> None:
    """Run ``task`` on its rank's grid rows over ``axis`` (a model axis;
    spatial sharding), or with None on whole rows again: the batches' and
    the modules' rows (``sp``, a latent model's frozen VAE's too), the
    draws of a diffusion task, and the loss's and BatchNorm's sums over
    every rank of the world (``DataMesh.cells``) or the data axis."""
    task.rows = axis
    field = task.mesh if axis is None else task.mesh.cells()
    task.loss_fn.mesh = field
    vae = getattr(task, "vae", None)
    for module in [*task.model.modules(), *(() if vae is None else vae.modules())]:
        if hasattr(module, "sp"):
            module.sp = axis
        if isinstance(module, BatchNorm):
            module.mesh = field


def check_spatial(model, mesh: DataMesh, field_shape) -> None:
    """Raise, naming the limit, unless ``model`` can run on a rank's rows of
    a grid of ``field_shape`` over ``mesh``'s model axis: a model that
    :data:`SPATIAL_MODELS` holds, and rows that divide over the axis. A
    deeper level of a model that halves the grid may leave a rank without
    a row (``parallel/spatial.py::Rows``)."""
    if not isinstance(model, SPATIAL_MODELS):
        raise NotImplementedError(
            f"--shard_spatial 1 with {type(model).__name__}: not a model of main_auto")
    mesh.rows(field_shape[0])


class ModelSplit:
    """``task.model`` laid over the mesh's model axis for training
    (:func:`split_model`): ``trained``, the module the optimizer trains
    (the model, or under pp this rank's :class:`PipelineStage`);
    ``layout``, its one-process layout; ``summed``, the parameters whose
    gradients sum over the model ranks, ``averaged`` those whose gradients
    average over them; ``pipeline``, the stage or None."""

    def __init__(self, trained, layout, summed=(), averaged=(), pipeline=None, hooks=()):
        self.trained, self.layout = trained, layout
        self.summed, self.averaged = list(summed), list(averaged)
        self.pipeline, self.hooks = pipeline, list(hooks)


def split_module(module: nn.Module, mesh: DataMesh, spatial: bool = False
                 ) -> Optional[ModelSplit]:
    """Lay ``module`` over ``mesh``'s model axis by gathering at use: each
    parameter that the JAX rules split (at ``sharding_rules.MIN_SIZE``,
    read at the call) keeps this rank's slice, and
    hooks gather the slices into the whole for each forward
    (``parallel/tensor.py::gather_at_use``); the whole parameters, which
    every model rank uses whole, have their gradients averaged over the
    model ranks (:func:`reduce_gradients`). With ``spatial`` the hooks
    gather every split parameter for the model's whole forward and average
    its gradient over the model ranks before taking the slice (each rank's
    is the partial of its rows). None without a model axis.
    :func:`join_split` undoes it."""
    axis = mesh.model
    if not axis.distributed:
        return None
    axes = shard_params(module, axis, sharding_rules.MIN_SIZE)
    averaged = [p for n, p in module.named_parameters() if axes[n] is None]
    return ModelSplit(module, ShardedLayout(module, axes, axis), averaged=averaged,
                      hooks=gather_at_use(module, axes, axis, spatial))


def join_split(module: nn.Module, split: Optional[ModelSplit]) -> None:
    """``module`` whole on every rank again after a tensor-parallel
    :class:`ModelSplit` (a collective over the model ranks), its hooks
    removed."""
    if split is None:
        return
    params = dict(module.named_parameters())
    for name, dim in split.layout.axes.items():
        if dim is not None:
            params[name].data = all_gather(params[name].data, dim, split.layout.axis)
    for hook in split.hooks:
        hook.remove()


def whole_state(module: nn.Module, split: Optional[ModelSplit]) -> Dict[str, torch.Tensor]:
    """``module``'s state dict in the one-process layout: gathered over the
    model ranks under a tensor-parallel :class:`ModelSplit` (a collective),
    else the state dict itself."""
    sd = module.state_dict()
    return sd if split is None else split.layout.to_std(sd)


def reduce_gradients(mesh: DataMesh, split: Optional[ModelSplit], params) -> None:
    """After the backward: under a :class:`ModelSplit` the gradients of its
    ``summed`` parameters summed over the model ranks and those of its
    ``averaged`` ones averaged over them; then every gradient of
    ``params`` averaged over the data ranks."""
    if split is not None:
        mesh.sum_over_model(split.summed)
        mesh.sum_over_model(split.averaged, mean=True)
    mesh.average_gradients(params)


def split_model(task, pp_microbatches: int = 0, spatial: bool = False) -> None:
    """Lay ``task.model`` over ``task.mesh``'s model axis (none: nothing to
    do). Under pp (``pp_microbatches``) the FNO's blocks are staged; else
    each parameter that the JAX rules split keeps this rank's slice, the
    FNO running column- and row-parallel, any other model gathering its
    slices at use (:func:`split_module`); the whole parameters that every
    rank uses whole have their gradients averaged over the model ranks.
    With ``spatial`` every model gathers at use and runs on its rank's
    grid rows (:func:`use_spatial`), except under pp: the JAX pipeline takes
    the batch as ``P(data)``, so every stage runs whole rows and the step is
    pp's alone."""
    axis, model = task.mesh.model, task.model
    if spatial and axis.distributed and not pp_microbatches:
        task.split = split_module(model, task.mesh, spatial=True)
        use_spatial(task, axis)
        return
    if pp_microbatches and not axis.distributed:
        raise ValueError(
            f"--pp_microbatches {pp_microbatches} requires a mesh with a model axis > 1; pass "
            "--mesh_shape NxM with M > 1, or drop --pp_microbatches")
    if pp_microbatches and not isinstance(model, fno.Fno2d):
        raise ValueError("--pp_microbatches supports --model fno (the staged-depth model); got "
                         f"{type(model).__name__}")
    if not axis.distributed:
        return
    if pp_microbatches:
        stage = PipelineStage(model, axis, pp_microbatches, lift=fno.lift, head=fno.head)
        print(f"pp: {axis.size} stages x {pp_microbatches} microbatches "
              f"(+{task.mesh.size}-way dp)")
        stage.release(model)
        task.split = ModelSplit(stage, stage, stage.summed, pipeline=stage)
        return
    if not isinstance(model, fno.Fno2d):
        task.split = split_module(model, task.mesh)
        return
    axes = shard_params(model, axis, sharding_rules.MIN_SIZE)
    model.tp = axis
    summed = model.tp_summed()
    in_part = {id(p) for p in summed}
    averaged = [p for n, p in model.named_parameters()
                if axes[n] is None and id(p) not in in_part]
    task.split = ModelSplit(model, ShardedLayout(model, axes, axis), summed, averaged)


def join_model(task) -> None:
    """Undo :func:`split_model`: ``task.model`` whole on every rank again
    (a collective over the model ranks)."""
    split = getattr(task, "split", None)
    if split is None:
        return
    if getattr(task, "rows", None) is not None:
        use_spatial(task, None)
    if split.pipeline is not None:
        split.pipeline.fill(task.model)
    else:
        join_split(task.model, split)
        task.model.tp = None
    task.split = None


def trained_module(task) -> nn.Module:
    split = getattr(task, "split", None)
    return task.model if split is None else split.trained


def train_step(task: AutoTask, optimizer: torch.optim.Optimizer, scheduler,
               batch, draws=None) -> Dict[str, torch.Tensor]:
    """One update; returns the batch's scores, detached, on the device.
    ``draws`` is the step's ``task.step_draws``. Under data parallelism
    ``batch`` is this rank's block and the gradients are averaged over the
    ranks before the update; under a :class:`ModelSplit` the gradients of
    its ``summed`` parameters are first summed over the model ranks, and
    under pp the step is the pipeline's GPipe schedule."""
    optimizer.zero_grad(set_to_none=True)
    split = getattr(task, "split", None)
    if split is not None and split.pipeline is not None:
        def loss_of(preds):
            s = task.scores(preds, batch)
            return s[task.loss_fn.objective], s

        _, scores = split.pipeline.forward_backward(batch["inputs"], batch["case_params"],
                                                    batch["mask"], loss_of, task.compute_dtype)
    else:
        loss, scores = task.loss_scores(batch, draws)
        loss.backward()
    reduce_gradients(task.mesh, split, trained_module(task).parameters())
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
    means, the predictions if asked for, and the plots (rank 0's); at most
    ``max_eval_batches`` batches when given."""
    mesh, rows = task.mesh, getattr(task, "rows", None)
    keep_preds = collect_preds or bool(plot_interval)
    names = task.loss_fn.get_score_names()
    score_rows = []  # (2, n_names) per batch, on the device: [pred, input baseline]
    all_preds, n_valids = [], []
    plot_panels = {}  # step -> (input u, label u) of the batch's first sample
    task.model.eval()
    for step, host in enumerate(batches(dataset_arrays(data), batch_size, shuffle=False,
                                        pad_multiple=mesh.size)):
        if max_eval_batches is not None and step >= max_eval_batches:
            break
        n_valids.append(int(host["weights"].sum()))
        if plot_interval and step % plot_interval == 0:
            plot_panels[step] = (host["inputs"][0, ..., 0].copy(),
                                 host["labels"][0, ..., 0].copy())
        batch = to_device(field_rows(mesh.block(host), rows), device)
        if task.generative:
            s, isc, preds = gen_eval_step(task, batch)
        else:
            s, isc, preds = eval_step(task, batch, with_preds=keep_preds)
        score_rows.append(torch.stack([torch.stack([s[k] for k in names]),
                                       torch.stack([isc[k] for k in names])]))
        if keep_preds:
            all_preds.append(mesh.gather(gather_rows(preds, rows)))
    # One device-to-host transfer for every batch's scores.
    mat = (torch.stack(score_rows).cpu().numpy() if score_rows
           else np.zeros((0, 2, len(names))))
    scores = {k: mat[:, 0, i].tolist() for i, k in enumerate(names)}
    input_scores = {k: mat[:, 1, i].tolist() for i, k in enumerate(names)}
    preds_host = None
    if all_preds:
        stacked = torch.stack(all_preds).cpu().numpy()
        preds_host = np.concatenate([p[:nv] for p, nv in zip(stacked, n_valids)])
    if plot_interval and preds_host is not None and not task.pointwise and mesh.is_main():
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
    if "nmse" in scores and mesh.is_main():
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
    pp_microbatches: int = 0,
    spatial: bool = False,
) -> List[float]:
    """Train ``task.model`` in place; returns the per-step losses.
    ``resume=True`` continues from ``output_dir/training_state`` (the
    weights, the optimizer's moments and step, the schedule's position)
    and ``training_meta.json`` when both are there; every eval epoch
    writes them. ``eval_max_batches`` caps the dev evaluation. Under data
    parallelism (``task.mesh``) ``batch_size`` and ``eval_batch_size`` are
    global; with a model axis the model is split for the run
    (:func:`split_model`, ``pp_microbatches`` for pp; ``spatial``: each
    model rank on its grid rows) and whole again when it returns."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    model, mesh = task.model, task.mesh
    if pp_microbatches and opt_state == "factored":
        raise ValueError(
            "--opt_state_dtype factored is not supported with pipeline parallelism: adafactor "
            "keeps per-tensor statistics, which over the packed (stages, per, ...) stage leaves "
            "would diverge from the single-device update; use f32 or bf16")
    n_params = sum(p.numel() for p in model.parameters())
    if spatial:
        check_spatial(model, mesh, train_data.field_shape)
    split_model(task, pp_microbatches, spatial)
    split, rows = getattr(task, "split", None), getattr(task, "rows", None)
    trained = trained_module(task)
    layout = None if split is None else split.layout
    shards = {}
    if split is not None and split.pipeline is None:
        params = dict(model.named_parameters())
        shards = {params[n]: d for n, d in layout.axes.items() if d is not None}
    steps_per_epoch = num_batches(len(train_data), batch_size)
    optimizer, scheduler = make_adam(trained.parameters(), lr, gamma=lr_gamma,
                                     lr_step_size=lr_step_size,
                                     steps_per_epoch=steps_per_epoch, opt_state=opt_state,
                                     shards=shards, axis=mesh.model)
    # For the log only; the optimizer's rate comes from the same rule.
    lr_schedule = step_lr_schedule(lr, lr_gamma, lr_step_size, steps_per_epoch)
    arrays = dataset_arrays(train_data)

    start_epoch, global_step, train_losses = 0, 0, []
    meta_path = output_dir / "training_meta.json"
    if resume and meta_path.exists() and (output_dir / checkpoints.STATE_DIR).exists():
        meta = load_json(meta_path)
        global_step = checkpoints.load_training_state(output_dir, trained, optimizer, scheduler,
                                                      layout)
        start_epoch = meta["epoch"] + 1
        # The loss history is saved beside the state. Truncate it to the
        # committed epoch: a finished run's final dump holds epochs past
        # the last snapshot, which are about to be trained again.
        losses_path = output_dir / "train_losses.json"
        train_losses = load_json(losses_path) if losses_path.exists() else []
        train_losses = train_losses[: start_epoch * steps_per_epoch]
        print(f"Resumed from epoch {meta['epoch']}")

    on_rank = sum(p.numel() for p in trained.parameters())
    print(f"Model has {n_params} parameters"
          + (f" ({on_rank} on this rank)" if split is not None else ""))
    pad_multiple = mesh.size * max(1, pp_microbatches)
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
        for step, host in enumerate(batches(arrays, batch_size, shuffle=True, rng=rng,
                                            pad_multiple=pad_multiple)):
            draws = task.step_draws(seed, global_step, device)
            batch = to_device(field_rows(mesh.block(host), rows), device)
            scores = train_step(task, optimizer, scheduler, batch, draws)
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
            join_model(task)
            return ep_losses

        train_losses += ep_losses
        if (ep + 1) % eval_interval == 0:
            ckpt_dir = output_dir / f"ckpt-{ep}"
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            if split is not None and split.pipeline is not None:
                split.pipeline.fill(model)  # evaluated in the one-process layout, as JAX unpacks
            dev_scores = evaluate(task, dev_data, ckpt_dir, device=device,
                                  batch_size=eval_batch_size, collect_preds=False,
                                  max_eval_batches=eval_max_batches)["scores"]
            if plot_examples:
                # The train-time example.png (src/train_auto.py:234-250):
                # the first dev sample, rank 0's first row.
                pb = next(batches(dataset_arrays(dev_data), eval_batch_size, shuffle=False,
                                  pad_multiple=mesh.size))
                b = to_device(field_rows(mesh.block(pb), rows), device)
                with torch.no_grad():
                    pred = gather_rows(task.predict_frame(b["inputs"], b["case_params"],
                                                          b["mask"]), rows)
                if mesh.is_main():
                    plot_example(inp=pb["inputs"][0, ..., 0], label=pb["labels"][0, ..., 0],
                                 pred=pred[0, ..., 0].cpu().numpy(),
                                 out_path=output_dir / "example.png")
            # The one-process layout: gathered over the model ranks under tp,
            # the blocks just filled from their stages under pp.
            weights = model.state_dict()
            if split is not None and split.pipeline is None:
                weights = layout.to_std(weights)
            checkpoints.save_training_state(output_dir, trained, optimizer, scheduler,
                                            global_step, layout, write=mesh.is_main())
            if split is not None and split.pipeline is not None:
                split.pipeline.release(model)
            if mesh.is_main():
                dump_json(dev_scores, ckpt_dir / "dev_scores.json")
                dump_json(ep_losses, ckpt_dir / "train_loss.json")
                dev_key = "nmse" if "nmse" in dev_scores["all"] else objective
                checkpoints.save_checkpoint(
                    weights, ckpt_dir, ep=ep, train_loss=float(np.mean(ep_losses)),
                    dev_loss=float(np.mean(dev_scores["all"][dev_key])),
                    time=time.time() - ep_start)
                # Losses before meta: training_meta.json commits the
                # snapshot, so a kill between the two writes leaves the
                # history at or ahead of the commit, never behind it
                # (resume truncates any overshoot).
                dump_json(train_losses, output_dir / "train_losses.json")
                dump_json(dict(epoch=ep, global_step=global_step),
                          output_dir / "training_meta.json")
            mesh.barrier()
    print("====== Training done ======")
    join_model(task)
    if mesh.is_main():
        dump_json(train_losses, output_dir / "train_losses.json")
        plot_loss(train_losses, output_dir / "train_losses.png")
    mesh.barrier()
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
    ``src/train_auto.py:151-178``); under data parallelism rank 0 writes
    them and the others wait."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    result = evaluate(task, data, output_dir, device=device, batch_size=batch_size,
                      plot_interval=plot_interval)
    if task.mesh.is_main():
        if result.get("preds") is not None:
            np.save(output_dir / "preds.npy", result["preds"])
        dump_json(result["scores"], output_dir / "scores.json")
    task.mesh.barrier()
