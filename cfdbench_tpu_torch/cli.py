"""CLI entry points of the port (counterpart of ``cfdbench_tpu/cli.py``).

- ``main_auto`` (train / test) trains the autoregressive models: ``fno``,
  ``ffno``, ``unet``, ``resnet``, ``auto_ffn``, ``auto_deeponet``,
  ``auto_edeeponet``, ``auto_deeponet_cnn``, ``pixel_diffusion`` and the
  latent diffusion models (``latent_diffusion``, ``latent_diffusion2``,
  ``latent_diffusion_lite``, ``latent_diffusion2_lite``), these on the
  frozen VAE at ``--ldm_vae_weights_path``.
- ``main_vae`` trains that VAE.
- ``main_train`` (train / test) trains the non-autoregressive ``ffn``
  and ``deeponet``.
- ``main_gencast`` (train / test) trains GenCast.
- ``main_uncond`` trains the unconditional DDPM with its EMA.
- ``main_multistep`` rolls out every kind: a self-feeding rollout for
  the autoregressive models (``auto_deeponet_cnn``'s raises, as the JAX
  package's does; pixel diffusion's samples each frame with fresh
  noise), GenCast's two-frame window, one whole-lattice generation a
  step for the non-autoregressive ones.

They take the JAX package's flags (the port's copy of them,
``config.Args``) and run on the CUDA card; without one they raise. Only
a caller that asks for the CPU (``device="cpu"``, as the tests do) runs
there, through the FNO kernels' plain PyTorch versions; the other
models' convolutions, FFTs and products are PyTorch calls on either
device. A flag whose behaviour the port does not have raises and names
the ROADMAP.md item that will bring it; so does a flag that the JAX
entry point parses and ignores (ROADMAP.md C). Two flags keep their
defaults in every run and are ignored by ``main_train``, as the JAX
package ignores them: ``--eval_batch_size`` (its evaluation runs
batches of 64) and ``--plot_train_examples`` (it plots no example).
``--use_pallas_head`` changes nothing here: on the card both FNO
kernels always run.

Every trainer (``main_auto``, ``main_train``, ``main_gencast``,
``main_vae``, ``main_uncond``) and ``main_multistep`` run data-parallel
under ``torchrun --nproc_per_node N`` with ``--mesh_shape N``, one card a
rank (``parallel/mesh.py``). Each also takes a model axis,
``--mesh_shape NxM`` under ``torchrun --nproc_per_node N·M``, in float32
and in bfloat16 (``--use_mixed_precision``, ``--rollout_dtype
bfloat16``): tensor parallelism in ``main_auto``, ``main_gencast``,
``main_vae``, ``main_uncond`` and the autoregressive and GenCast
``main_multistep`` (``training/trainer_auto.py::split_model``,
``split_module``), pipeline parallelism of the FNO in ``main_auto`` with
``--pp_microbatches K``, and in ``main_train`` a replicated model axis, as
the JAX trainer keeps it. The non-autoregressive ``main_multistep`` refuses
any mesh, as the JAX one ignores it (ROADMAP.md C), and ``--pp_microbatches``
is refused outside ``main_auto`` and for a latent model. ``main_auto`` takes
``--shard_spatial 1`` for every model, in float32 and under
``--use_mixed_precision``: over the model axis each rank trains and
evaluates on its H/M grid rows (``parallel/spatial.py``,
``training/trainer_auto.py``), its test mode on whole rows, as the JAX
``main_auto`` runs it; with ``--pp_microbatches`` every pipeline stage runs
whole rows, as the JAX pipeline takes its batch, so the step is pp's.
``main_train`` and ``main_gencast`` refuse it, as the JAX ones ignore it
(ROADMAP.md C).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .config import Args
from .data import get_auto_dataset, get_dataset, load_test_cases
from .data.core import dump_json
from .data.wrapper import (
    compute_residual_stats,
    load_residual_stats,
    save_residual_stats,
    wrap_gencast,
)
from .metrics import loss_name_to_fn
from .data.vae_data import build_vae_dataset
from .models import (
    DIFFUSION_MODELS,
    LATENT_MODELS,
    NONAUTO_MODELS,
    check_model_ported,
    init_auto_model,
    init_gencast,
    init_latent_diffusion,
    init_nonauto_model,
    init_pixel_diffusion,
    make_cfd_vae,
)
from .models.fno import HEAD_WIDTH
from .models.point import NO_ROLLOUT
from .ops import _build
from .ops.fno_kernels import check_kernel_shapes, launch_counts
from .parallel.mesh import data_size, open_mesh, parse_spec
from .training import trainer_auto, trainer_gencast, trainer_nonauto, trainer_uncond, trainer_vae
from .training.checkpoints import load_best_params, load_params
from .training.rollout import make_rollout_fn, multistep_metrics
from .training.trainer_auto import AutoTask, use_mesh
from .training.trainer_nonauto import NonAutoTask
from .utils.artifacts import get_output_dir, plot_multistep_metrics
from .utils.device import F32_PRECISIONS, TF32_PRECISIONS, entry_device, set_numerics
from .utils.profiling import profile_trace

INFER_STEPS = 20


def parse_args(argv=None) -> Args:
    """The JAX package's flags, parsed from ``argv`` (``sys.argv`` when None)."""
    return Args.parse_args(argv)


def run_dir(args: Args) -> Path:
    """The result directory of a run with these flags, where its
    ``ckpt-*`` and ``multistep_metrics.json`` live: under ``auto/`` for
    an autoregressive model, ``non-auto/`` for the others."""
    return get_output_dir(args, is_auto=args.model not in NONAUTO_MODELS)


def check_supported(args: Args) -> None:
    """Raise on every flag value, read by every entry point, whose
    behaviour the port does not have."""
    check_model_ported(args.model)
    check_runtime_flags(args)
    if args.model in LATENT_MODELS and args.vae_variant != "lite":
        raise ValueError(
            f"--vae_variant {args.vae_variant} with --model {args.model}: the latent models "
            "decode with a lite VAE (cfdbench_tpu/models/diffusion.py:375, 584); the JAX "
            "package restores other variants' weights into it and fails on their shapes "
            "(ROADMAP.md C)")


def check_runtime_flags(args: Args) -> None:
    """Raise on the flags that every JAX entry point reads
    (``_apply_runtime_flags``, ``_mesh``) set to a behaviour the port lacks.
    ``--profile_dir`` is taken: each entry point runs inside
    :func:`~.utils.profiling.profile_trace`. ``--matmul_precision`` is
    taken for the values that JAX runs on an NVIDIA card as TF32 (cuBLAS,
    cuDNN and the FNO's kernels in TF32 on the card) or as float32
    (``default`` among them: PyTorch's own default, ROADMAP.md C); the
    entry point sets them (``utils/device.py::set_numerics``)."""
    if args.spectral_backend != "auto":
        raise NotImplementedError(
            f"--spectral_backend {args.spectral_backend}: the DFT-matmul "
            "backends were TPU workarounds and are not ported (ROADMAP.md "
            "A17); the port runs torch.fft on the CPU and the fused kernel "
            "on the card"
        )
    if args.compilation_cache_dir:
        raise NotImplementedError(
            "--compilation_cache_dir: the port has no XLA cache; its kernels "
            "are built once into build/cfdbench_tpu_torch (ROADMAP.md A17)"
        )
    if args.matmul_precision not in TF32_PRECISIONS + F32_PRECISIONS:
        raise NotImplementedError(
            f"--matmul_precision {args.matmul_precision}: the port runs the values that "
            f"JAX runs on an NVIDIA card as TF32 ({', '.join(TF32_PRECISIONS)}) or as "
            f"float32 ({', '.join(F32_PRECISIONS)}); the others are not ported "
            "(ROADMAP.md A17)"
        )


def model_axis(args: Args) -> int:
    """The model-axis size of ``--mesh_shape``."""
    return parse_spec(args.mesh_shape)[1]


def check_rollout_flags(args: Args) -> None:
    """``check_supported`` and the flags only ``main_multistep`` reads.
    ``--rollout_dtype bfloat16`` is taken for the deterministic
    autoregressive models; where the JAX ``main_multistep`` prints that it
    drops it (a diffusion model, the FNO with ``--use_pallas_head 1``) or
    never reads it (GenCast, the non-autoregressive models), it raises.
    A mesh of more than one rank is refused for the non-autoregressive
    models, whose JAX branch ignores it (ROADMAP.md C)."""
    check_supported(args)
    if args.model == "auto_deeponet_cnn":
        raise ValueError(f"--model {NO_ROLLOUT}")
    if args.model in NONAUTO_MODELS and data_size(args.mesh_shape) * model_axis(args) > 1:
        raise NotImplementedError(
            f"--mesh_shape {args.mesh_shape} with --model {args.model}: the JAX "
            "main_multistep ignores the mesh for the non-autoregressive models (ROADMAP.md "
            "C); data parallelism (A15a) rolls out the autoregressive models and GenCast")
    if args.rollout_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"--rollout_dtype {args.rollout_dtype!r}: choose float32 or bfloat16"
        )
    if args.rollout_dtype == "bfloat16":
        dropped = ""
        if args.model == "pixel_diffusion" or args.model in LATENT_MODELS:
            dropped = (f"--model {args.model}: the JAX main_multistep prints that a "
                       "diffusion rollout runs float32 and ignores it")
        elif args.model == "fno" and args.use_pallas_head:
            dropped = ("--use_pallas_head 1: the JAX main_multistep prints that its Pallas "
                       "head runs float32 and ignores it")
        elif args.model == "gencast" or args.model in NONAUTO_MODELS:
            dropped = f"--model {args.model}: the JAX main_multistep ignores it"
        if dropped:
            raise NotImplementedError(
                f"--rollout_dtype bfloat16 with {dropped} (ROADMAP.md C)")


def check_training_flags(args: Args, regime: str = "auto") -> None:
    """``check_supported`` and the flags only the trainers read:
    ``main_auto``'s (``regime="auto"``), ``main_train``'s (``"nonauto"``)
    or ``main_gencast``'s (``"gencast"``), whose model must be of that
    kind. ``--use_gradient_checkpointing`` is taken where the JAX package
    applies it, by the PUNetG models; ``--gradient_accumulation_steps`` by
    ``main_gencast`` alone; ``--use_mixed_precision`` by ``main_auto`` and
    ``main_gencast``; ``--opt_state_dtype`` by ``main_auto``;
    ``--shard_spatial 1`` by ``main_auto``; ``--pp_microbatches`` by
    ``main_auto`` for the FNO alone, refused by name for a latent model."""
    check_supported(args)
    check_model_ported(args.model, regime)
    if args.mode not in ("train", "test", "train_test"):
        raise ValueError(f"--mode {args.mode!r}: choose train, test or train_test")
    entry = {"auto": "main_auto", "nonauto": "main_train", "gencast": "main_gencast"}[regime]
    if regime == "auto" and args.pp_microbatches and args.model in LATENT_MODELS:
        raise NotImplementedError(
            f"--pp_microbatches with --model {args.model}: pipeline parallelism stages the FNO "
            "alone (ROADMAP.md A15e)")
    if regime != "auto" and args.pp_microbatches:
        raise NotImplementedError(
            f"--pp_microbatches in {entry}: pipeline parallelism stages the FNO in "
            "main_auto (ROADMAP.md A15e)")
    # Flags the JAX entry point parses and never passes to its trainer
    # (ROADMAP.md C), each with whether this run sets it.
    ignored = {}
    if regime != "auto":
        ignored["--shard_spatial"] = bool(args.shard_spatial)
    if regime != "gencast":
        ignored[f"--gradient_accumulation_steps {args.gradient_accumulation_steps}"] = (
            args.gradient_accumulation_steps != 1)
    if args.model not in DIFFUSION_MODELS:
        ignored["--use_gradient_checkpointing"] = args.use_gradient_checkpointing
    if regime == "nonauto":
        ignored.update({
            "--use_mixed_precision": args.use_mixed_precision,
            f"--opt_state_dtype {args.opt_state_dtype}": args.opt_state_dtype != "f32",
            f"--cache_dir {args.cache_dir}": bool(args.cache_dir),
        })
    elif regime == "gencast":
        ignored.update({
            f"--opt_state_dtype {args.opt_state_dtype}": args.opt_state_dtype != "f32",
            "--measure_time": bool(args.measure_time),
        })
    for flag, is_set in ignored.items():
        if is_set:
            raise NotImplementedError(
                f"{flag}: not ported; the JAX {entry} ignores it (ROADMAP.md C)"
            )


def refuse_ignored(args: Args, names, entry: str) -> None:
    """Raise on each flag of ``names`` set off its default: the JAX
    ``entry`` parses it and never reads it (ROADMAP.md C)."""
    default = Args()
    for name in names:
        value = getattr(args, name)
        if value != getattr(default, name):
            raise NotImplementedError(
                f"--{name} {value}: not ported; the JAX {entry} ignores it (ROADMAP.md C)")


# Training flags that the JAX main_vae and the unconditional script parse
# and never read.
_UNREAD_TRAINING_FLAGS = (
    "weight_decay", "eval_batch_size", "lr_step_size", "lr_gamma", "loss_name", "log_interval",
    "eval_interval", "use_mixed_precision", "use_gradient_checkpointing",
    "gradient_accumulation_steps", "opt_state_dtype", "measure_time", "pp_microbatches",
    "shard_spatial")
VAE_MODES = ("train", "train_anneal")


def check_vae_flags(args: Args) -> None:
    """``main_vae``'s flags: ``--mode train`` or ``train_anneal`` (KL
    annealing exactly when "anneal" is in it, as in the JAX package), and
    none of the VAE and training flags that the JAX ``main_vae`` never
    reads."""
    check_runtime_flags(args)
    if args.mode not in VAE_MODES:
        raise ValueError(f"--mode {args.mode!r}: main_vae trains; choose train or train_anneal "
                         "(the JAX main_vae trains whatever --mode says, ROADMAP.md C)")
    refuse_ignored(args, ("resolution", "dropout", "embed_dim", "kl_weight")
                   + _UNREAD_TRAINING_FLAGS, "main_vae")


def check_uncond_flags(args: Args) -> None:
    """The unconditional script's flags: its PUNetG's base width and
    timesteps, the data, ``--lr``, ``--batch_size``, ``--num_epochs``,
    ``--seed`` and ``--resume``; none that the JAX script never reads."""
    check_runtime_flags(args)
    refuse_ignored(args, ("mode", "pixel_diffusion_channel_mults",
                          "pixel_diffusion_num_res_blocks", "pixel_diffusion_dropout",
                          "ldm_num_inference_steps") + _UNREAD_TRAINING_FLAGS,
                   "train_diffusion_uncond.py")


def check_fno_kernel_shapes(args: Args, field_shape, device: torch.device) -> None:
    """On the card, raise if the FNO's kernels cannot take its widths and
    modes on the data's grid; the other models run no kernel of ours."""
    if args.model == "fno" and device.type == "cuda":
        check_kernel_shapes(*field_shape, args.fno_hidden_dim, args.fno_modes_x,
                            args.fno_modes_y, HEAD_WIDTH, args.out_chan)


def build_kernels_once(args: Args, device: torch.device, mesh) -> None:
    """Under data, tensor or pipeline parallelism on the card, rank 0 builds
    the FNO's kernels (``ops/_build.py``) while the other ranks wait, so
    that they load the library rather than each compile it."""
    if args.model == "fno" and device.type == "cuda" and mesh.world_size > 1:
        if mesh.is_main():
            _build.build_library()
        mesh.barrier()


def make_auto_task(args: Args, n_case_params: int, field_shape, device):
    """The task ``main_auto`` trains for ``--model`` (``cfdbench_tpu.cli.make_auto_task``):
    an :class:`AutoTask` around the model, the pixel-diffusion task, or a
    latent diffusion task on the VAE at ``--ldm_vae_weights_path`` (a
    directory that holds only JAX weights raises with the command that
    converts them), computing in :func:`compute_dtype` in training."""
    loss_fn = loss_name_to_fn(args.loss_name)
    if args.model == "pixel_diffusion":
        task = init_pixel_diffusion(args, n_case_params, loss_fn, device=device)
    elif args.model in LATENT_MODELS:
        vae_state = load_params(Path(args.ldm_vae_weights_path))
        task = init_latent_diffusion(args, n_case_params, vae_state, loss_fn, device=device)
    else:
        model = init_auto_model(args, n_case_params=n_case_params, field_shape=field_shape,
                                device=device)
        task = AutoTask(model, loss_fn)
    task.compute_dtype = compute_dtype(args)
    return task


def compute_dtype(args: Args):
    """The dtype of the train forward: bfloat16 under ``--use_mixed_precision``
    (float32 parameters, optimizer, labels, loss and evaluation), else None."""
    return torch.bfloat16 if args.use_mixed_precision else None


def main_multistep(argv=None, device=None) -> torch.Tensor:
    """``cfdbench_tpu.cli.main_multistep`` (``src/test_multistep.py``):
    20 frames of every test case at once from the best checkpoint's
    ``model.pt``, then masked-u mse/nmse/mae per step, averaged over
    cases, into the run's ``multistep_metrics.json``.

    An autoregressive model rolls out, feeding back its own prediction;
    the ResNet's frames are ``[frame0, pred_1, …, pred_19]``
    (``include_initial``, as the JAX package aligns them); the point
    models feed back u alone; pixel diffusion samples each frame from
    fresh noise keyed by ``--seed`` and the step. GenCast rolls out its
    two-frame window from (frame0, frame0), from ``best_model/`` and
    ``residual_stats.npz``, its noise keyed by seed 0 as in the JAX
    package (``cli.py:517-559``). A non-autoregressive model generates
    each step's frame, ``t = s`` for s in 0..19, in one whole-lattice
    call over all cases (``test_multistep.py:119-132``), from its
    ``non-auto/`` run.

    Runs on the CUDA card unless ``device`` names another; with
    ``device`` None and no card it raises. On the card, FNO widths or
    modes that its kernels cannot take on the data's grid raise before
    the model is built. Returns the frames, ``(steps, cases, H, W,
    channels)``, on the device.

    Data parallelism (the autoregressive models and GenCast; ``main_auto``
    says how it is launched): the case axis is padded to a multiple of the
    rank count by repeating the last case, with weight 0 in the per-step
    means (``cfdbench_tpu/cli.py:474-516``); each rank rolls its block of
    cases out on its card, the frames are gathered, and rank 0 writes the
    metrics. Every rank returns every real case's frames. With a model axis
    (``--mesh_shape NxM``, the autoregressive models and GenCast) the
    parameters it rolls out are split over it, as ``main_auto`` and
    ``main_gencast`` split them for tensor parallelism, in float32 or
    bfloat16."""
    args = parse_args(argv)
    check_rollout_flags(args)
    device = entry_device(device)
    set_numerics(args.matmul_precision)
    with open_mesh(args.mesh_shape, device) as mesh, profile_trace(args.profile_dir, device):
        return _run_multistep(args, device, mesh)


def _run_multistep(args: Args, device: torch.device, mesh) -> torch.Tensor:
    print(args)
    print(f"[multistep] device: {device}, {mesh}")

    features, case_params = load_test_cases(args, INFER_STEPS)
    field_shape = features.shape[2:4]
    if args.rollout_dtype == "float32":  # a bfloat16 rollout runs no kernel
        check_fno_kernel_shapes(args, field_shape, device)
        build_kernels_once(args, device, mesh)
    n_real = features.shape[0]
    case_weights = None
    pad = (-n_real) % mesh.size
    if pad:
        features = np.concatenate([features, np.repeat(features[-1:], pad, axis=0)])
        case_params = np.concatenate([case_params, np.repeat(case_params[-1:], pad, axis=0)])
        case_weights = np.concatenate([np.ones(n_real, np.float32), np.zeros(pad, np.float32)])
    if mesh.size > 1:
        print(f"[multistep] sharding {features.shape[0]} cases ({n_real} real) over "
              f"{mesh.size} data-parallel ranks")
    frame0 = features[:, 0, :, :, :2]
    mask = features[:, 0, :, :, 2:3]
    output_dir = run_dir(args)

    def on_device(a):
        """This rank's block of a case-axis array, on the device."""
        return torch.as_tensor(
            np.ascontiguousarray(mesh.block(a), np.float32), device=device
        )

    before = launch_counts()
    P = case_params.shape[1]
    if args.model in NONAUTO_MODELS:
        model = init_nonauto_model(args, n_case_params=P, device=device)
        model.load_state_dict(load_best_params(output_dir))
        preds = generate_steps(NonAutoTask(model.eval()), on_device(case_params),
                               field_shape, INFER_STEPS)
    elif args.model == "gencast":
        stats = load_residual_stats(output_dir / "residual_stats.npz")
        task = init_gencast(args, stats, P, device=device)
        use_mesh(task, mesh)
        task.model.load_state_dict(load_params(output_dir / trainer_gencast.BEST_DIR))
        if trainer_auto.split_module(task.model, mesh) is not None:
            print(f"[multistep] tensor-sharding params over {mesh.model.size} model-axis ranks")
        f0 = on_device(frame0)
        preds = task.rollout(f0, f0, on_device(case_params), on_device(mask), INFER_STEPS)
    else:
        task = make_auto_task(args, P, field_shape, device)
        use_mesh(task, mesh)
        task.model.load_state_dict(load_best_params(output_dir))
        task.model.eval()
        trainer_auto.split_model(task)
        if mesh.model.distributed:
            print(f"[multistep] tensor-sharding params over {mesh.model.size} model-axis ranks")
        rollout = make_rollout_fn(task.predict_frame, steps=INFER_STEPS,
                                  include_initial=(args.model == "resnet"),
                                  stochastic=task.generative, seed=args.seed)
        inputs = [on_device(frame0[..., :task.feedback_channels]), on_device(case_params),
                  on_device(mask)]
        if args.rollout_dtype == "bfloat16":
            # The JAX package's bf16-storage rollout (cli.py:589-617): the
            # weights, the running statistics and the inputs cast once; the
            # carried frames stay bfloat16 (rollout.unroll), the metrics below
            # score them widened to float32. The FNO runs no kernel in it.
            task.model.to(torch.bfloat16)
            inputs = [a.to(torch.bfloat16) for a in inputs]
        preds = rollout(*inputs)
    print_launches("multistep", before)
    if mesh.distributed:  # every rank's cases, in float32 (exact for bfloat16)
        preds = mesh.gather(preds.transpose(0, 1).float()).transpose(0, 1).to(preds.dtype)
    metrics = multistep_metrics(preds, features, mask, case_weights=case_weights)
    for m in metrics:
        print(m)
    if mesh.is_main():
        dump_json(metrics, output_dir / "multistep_metrics.json")
        plot_multistep_metrics(metrics, output_dir / "multistep_metrics.pdf")
    mesh.barrier()
    return preds[:, :n_real]


def generate_steps(task: NonAutoTask, case_params: torch.Tensor, field_shape,
                   steps: int) -> torch.Tensor:
    """``(steps, cases, H, W, 1)``: step s is one ``generate_one`` call at
    ``t = s`` over every case and the whole lattice, the calls the JAX
    package makes (a DeepONet's prediction at a point depends on the
    other points of its call, so the call is never split)."""
    H, W = field_shape
    C = case_params.shape[0]
    with torch.inference_mode():
        frames = torch.empty((steps, C, H, W, 1), device=case_params.device)
        for s in range(steps):
            t = torch.full((C, 1), float(s), device=case_params.device)
            frames[s] = task.generate_one(case_params, t, H, W)
    return frames


def main_auto(argv=None, device=None):
    """The autoregressive branch of ``cfdbench_tpu.cli.main_auto``
    (``src/train_auto.py:316-378``): ``--mode train`` trains with Adam
    and StepLR and writes ``ckpt-{ep}/`` per eval epoch, ``test`` scores
    the best checkpoint on the test split, ``train_test`` does both.
    The diffusion models are scored on the frames they generate, their dev
    evaluation on at most ``--max_eval_batches`` batches; the latent ones
    decode with the VAE at ``--ldm_vae_weights_path``, which must be a lite
    VAE (``main_vae``'s output).
    Runs on the CUDA card unless ``device`` names another; with
    ``device`` None and no card it raises. On the card, FNO widths or
    modes that its kernels cannot take on the data's grid raise before
    the model is built.

    Data parallelism: under ``torchrun --nproc_per_node N`` with
    ``--mesh_shape N`` (``Nx1``, or ``auto``) each rank trains on its card,
    ``cuda:LOCAL_RANK``, in an NCCL group (``parallel/mesh.py``), its
    block of each global ``--batch_size`` batch; a caller that has
    initialised a process group runs in it. Rank 0 writes the files.
    ``--mesh_shape NxM`` under ``torchrun --nproc_per_node N·M`` adds a
    model axis: tensor parallelism, or with ``--pp_microbatches K`` the
    FNO's GPipe pipeline (``trainer_auto.split_model``), or with
    ``--shard_spatial 1`` spatial sharding, each model rank on its rows of
    the grid in training and the dev evaluation; the checkpoints are in
    the one-process layout.

    Returns the task: its model as training left it, or, after ``test``,
    with the best checkpoint's weights."""
    args = parse_args(argv)
    check_training_flags(args, "auto")
    device = entry_device(device)
    set_numerics(args.matmul_precision)
    with open_mesh(args.mesh_shape, device) as mesh, profile_trace(args.profile_dir, device):
        return _run_auto(args, device, mesh)


def _run_auto(args: Args, device: torch.device, mesh):
    print("#" * 80)
    print(args)
    print("#" * 80)
    print(f"[auto] device: {device}, {mesh}")

    output_dir = run_dir(args)
    output_dir.mkdir(parents=True, exist_ok=True)
    if mesh.is_main():
        args.save(output_dir / "args.json")

    print("Loading data...")
    splits = ["train", "dev"] if "train" in args.mode else []
    if "test" in args.mode:
        splits.append("test")
    train_data, dev_data, test_data = get_auto_dataset(
        data_dir=Path(args.data_dir),
        data_name=args.data_name,
        delta_time=args.delta_time,
        norm_props=bool(args.norm_props),
        norm_bc=bool(args.norm_bc),
        load_splits=splits,
        seed=args.seed,
        cache_dir=args.cache_dir or None,
    )
    ref = train_data if train_data is not None else test_data
    print(f"# train examples: {len(train_data) if train_data else 0}")
    print(f"# dev examples: {len(dev_data) if dev_data else 0}")
    print(f"# test examples: {len(test_data) if test_data else 0}")
    check_fno_kernel_shapes(args, ref.field_shape, device)
    build_kernels_once(args, device, mesh)
    task = make_auto_task(args, ref.n_case_params, ref.field_shape, device)
    use_mesh(task, mesh)
    model = task.model

    if "train" in args.mode:
        if mesh.is_main():
            args.save(output_dir / "train_args.json")
        before = launch_counts()
        trainer_auto.train(
            task, train_data=train_data, dev_data=dev_data, output_dir=output_dir,
            device=device, lr=args.lr, lr_step_size=args.lr_step_size,
            lr_gamma=args.lr_gamma, num_epochs=args.num_epochs,
            batch_size=args.batch_size, eval_batch_size=args.eval_batch_size,
            eval_interval=args.eval_interval, log_interval=args.log_interval,
            seed=args.seed, measure_time=bool(args.measure_time),
            plot_examples=bool(args.plot_train_examples), resume=bool(args.resume),
            opt_state=args.opt_state_dtype,
            eval_max_batches=(args.max_eval_batches or None) if task.generative else None,
            pp_microbatches=args.pp_microbatches, spatial=bool(args.shard_spatial),
        )
        print_launches("train", before)
        if args.measure_time:
            # A micro-benchmark: print ms/step and stop (src/train.py:94-100).
            return task
    if "test" in args.mode:
        if mesh.is_main():
            args.save(output_dir / "test_args.json")
        model.load_state_dict(load_best_params(output_dir))
        before = launch_counts()
        trainer_auto.test(task, test_data, output_dir / "test", device=device,
                          batch_size=1, plot_interval=10)
        print_launches("test", before)
    return task


def main_train(argv=None, device=None) -> NonAutoTask:
    """``cfdbench_tpu.cli.main_train`` (``src/train.py:295-350``) for the
    non-autoregressive ``ffn`` and ``deeponet``: ``--mode train`` trains
    with Adam and StepLR on 1000 sampled lattice points a step and
    writes ``ckpt-{ep}/`` per eval epoch under ``non-auto/``, ``test``
    scores the best checkpoint's whole-lattice frames on the test split,
    ``train_test`` does both. Runs on the CUDA card unless ``device``
    names another; with ``device`` None and no card it raises.
    ``--eval_batch_size`` and ``--plot_train_examples`` are ignored, as
    in the JAX package. Data parallelism: as ``main_auto``; every rank
    draws a step's query points alike. ``--mesh_shape NxM`` keeps a
    replicated model axis, as the JAX trainer does: the M model ranks of a
    data rank train the same rows on the whole model. Returns the task, as
    ``main_auto`` does."""
    args = parse_args(argv)
    check_training_flags(args, "nonauto")
    device = entry_device(device)
    set_numerics(args.matmul_precision)
    with open_mesh(args.mesh_shape, device) as mesh, profile_trace(args.profile_dir, device):
        return _run_train(args, device, mesh)


def _run_train(args: Args, device: torch.device, mesh) -> NonAutoTask:
    print("#" * 80)
    print(args)
    print("#" * 80)
    print(f"[train] device: {device}, {mesh}")

    output_dir = run_dir(args)
    output_dir.mkdir(parents=True, exist_ok=True)
    if mesh.is_main():
        args.save(output_dir / "args.json")

    print("Loading data...")
    train_data, dev_data, test_data = get_dataset(
        data_name=args.data_name,
        data_dir=Path(args.data_dir),
        norm_props=bool(args.norm_props),
        norm_bc=bool(args.norm_bc),
        seed=args.seed,
    )
    print(f"# train examples: {len(train_data)}")
    print(f"# dev examples: {len(dev_data)}")
    print(f"# test examples: {len(test_data)}")
    model = init_nonauto_model(args, n_case_params=train_data.n_case_params, device=device)
    task = NonAutoTask(model, loss_name_to_fn(args.loss_name))
    use_mesh(task, mesh)

    if "train" in args.mode:
        if mesh.is_main():
            args.save(output_dir / "train_args.json")
        trainer_nonauto.train(
            task, train_data=train_data, dev_data=dev_data, output_dir=output_dir,
            device=device, lr=args.lr, lr_step_size=args.lr_step_size,
            lr_gamma=args.lr_gamma, num_epochs=args.num_epochs,
            batch_size=args.batch_size, eval_interval=args.eval_interval,
            log_interval=args.log_interval, seed=args.seed,
            measure_time=bool(args.measure_time), resume=bool(args.resume),
        )
        if args.measure_time:
            return task
    if "test" in args.mode:
        if mesh.is_main():
            args.save(output_dir / "test_args.json")
        model.load_state_dict(load_best_params(output_dir))
        trainer_nonauto.test(task, test_data, output_dir / "test", device=device, batch_size=1)
    return task


def main_gencast(argv=None, device=None):
    """``cfdbench_tpu.cli.main_gencast`` (``src/train_gencast.py``): GenCast
    on (X_{t−2}, X_{t−1}, X_t) triples of the auto dataset, whatever
    ``--model`` says, into the ``gencast`` run directory. The residual
    statistics are read from its ``residual_stats.npz``, or computed on
    the train split and cached there when it is missing (the reference
    requires the file). ``--mode train`` trains (AdamW, warmup-cosine,
    ``--gradient_accumulation_steps``, ``--use_gradient_checkpointing``)
    and resumes whenever a ``training_state/`` is there, as the JAX entry
    point does, its train loss in bfloat16 under ``--use_mixed_precision``;
    ``test`` generates and scores the test split from
    ``best_model/``; ``train_test`` does both. Runs on the CUDA card
    unless ``device`` names another; with ``device`` None and no card it
    raises. Data parallelism: as ``main_auto``; rank 0 computes and
    writes the residual statistics, which the other ranks then read, and
    the test split is generated a block of rows a rank, its frames
    gathered. ``--mesh_shape NxM`` splits the PUNetG over the model axis
    (tensor parallelism; ``trainer_gencast``), its checkpoints in the
    one-process layout. Returns the task."""
    args = dataclasses.replace(parse_args(argv), model="gencast")
    check_training_flags(args, "gencast")
    device = entry_device(device)
    set_numerics(args.matmul_precision)
    with open_mesh(args.mesh_shape, device) as mesh, profile_trace(args.profile_dir, device):
        return _run_gencast(args, device, mesh)


def _run_gencast(args: Args, device: torch.device, mesh):
    print(args)
    print(f"[gencast] device: {device}, {mesh}")
    splits = ["train", "dev"] + (["test"] if "test" in args.mode else [])
    train_data, dev_data, test_data = get_auto_dataset(
        data_dir=Path(args.data_dir),
        data_name=args.data_name,
        delta_time=args.delta_time,
        norm_props=bool(args.norm_props),
        norm_bc=bool(args.norm_bc),
        load_splits=splits,
        seed=args.seed,
        cache_dir=args.cache_dir or None,
    )
    gc_train, gc_dev = wrap_gencast(train_data), wrap_gencast(dev_data)
    print(f"# train triples: {len(gc_train)}, dev: {len(gc_dev)}")

    output_dir = run_dir(args)
    stats_path = output_dir / "residual_stats.npz"
    # Rank 0 writes the file that every rank reads; the barrier keeps the
    # others from reading it half written.
    if mesh.is_main() and not stats_path.exists():
        save_residual_stats(compute_residual_stats(gc_train), stats_path)
        print(f"Residual stats computed and cached at {stats_path}")
    mesh.barrier()
    stats = load_residual_stats(stats_path)
    print(f"residual mean={stats['residual_mean']}, std={stats['residual_std']}")
    task = init_gencast(args, stats, gc_train.n_case_params, loss_name_to_fn(args.loss_name),
                        device=device)
    task.compute_dtype = compute_dtype(args)
    use_mesh(task, mesh)
    if "train" in args.mode:
        trainer_gencast.train_gencast(
            task, gc_train, gc_dev, output_dir, device=device, num_epochs=args.num_epochs,
            lr=args.lr, batch_size=args.batch_size, eval_batch_size=args.eval_batch_size,
            eval_interval=args.eval_interval, log_interval=args.log_interval,
            weight_decay=args.weight_decay, grad_accum_steps=args.gradient_accumulation_steps,
            seed=args.seed, max_eval_batches=args.max_eval_batches,
        )
    if "test" in args.mode:
        task.model.load_state_dict(load_params(output_dir / trainer_gencast.BEST_DIR))
        trainer_gencast.test_gencast(task, wrap_gencast(test_data), output_dir / "test",
                                     device=device, batch_size=args.eval_batch_size)
    return task


def print_launches(what: str, before: dict) -> None:
    after = launch_counts()
    print(f"[{what}] kernel launches: " + ", ".join(
        f"{name}={after[name] - before[name]}" for name in after))


def main_vae(argv=None, device=None):
    """``cfdbench_tpu.cli.main_vae`` (``src/train_vae.py:82-276``): the
    ``--vae_variant`` VAE (``custom``: ``--ch``, ``--ch_mult``,
    ``--num_res_blocks``, ``--z_channels`` latents; else
    ``--ldm_latent_dim``) on the 64x64 label frames of the train and dev
    splits, its best weights to ``--ldm_vae_weights_path``, its history
    under ``<output_dir>/vae/<data_name>``; ``--mode train_anneal`` anneals
    the KL weight over ``--vae_kl_annealing_epochs``. Runs on the CUDA card
    unless ``device`` names another; with ``device`` None and no card it
    raises. Data parallelism: as ``main_auto``; every rank reads the same
    dev loss, so cuts its rate and stops on the same epoch.
    ``--mesh_shape NxM`` splits the VAE over the model axis (tensor
    parallelism; ``trainer_vae``). Returns the best weights, in the
    one-process layout."""
    args = parse_args(argv)
    check_vae_flags(args)
    device = entry_device(device)
    set_numerics(args.matmul_precision)
    with open_mesh(args.mesh_shape, device) as mesh, profile_trace(args.profile_dir, device):
        return _run_vae(args, device, mesh)


def _run_vae(args: Args, device: torch.device, mesh):
    print(args)
    print(f"[vae] device: {device}, {mesh}")
    train_data, dev_data, _ = get_auto_dataset(
        data_dir=Path(args.data_dir),
        data_name=args.data_name,
        delta_time=args.delta_time,
        norm_props=bool(args.norm_props),
        norm_bc=bool(args.norm_bc),
        load_splits=["train", "dev"],
        seed=args.seed,
        cache_dir=args.cache_dir or None,
    )
    vae_train, vae_dev = build_vae_dataset(train_data), build_vae_dataset(dev_data)
    print(f"# train frames: {len(vae_train)}, dev frames: {len(vae_dev)}")
    latent = args.z_channels if args.vae_variant == "custom" else args.ldm_latent_dim
    vae = make_cfd_vae(args.vae_variant, 2, 2, latent, ch=args.ch, ch_mult=tuple(args.ch_mult),
                       num_res_blocks=args.num_res_blocks,
                       generator=torch.Generator().manual_seed(args.seed), device=device)
    return trainer_vae.train_vae(
        vae, vae_train, vae_dev, output_dir=Path(args.output_dir) / "vae" / args.data_name,
        weights_path=Path(args.ldm_vae_weights_path), device=device,
        num_epochs=args.num_epochs, lr=args.lr, weight_decay=args.vae_weight_decay,
        batch_size=args.batch_size, kl_weight=args.vae_kl_weight,
        kl_annealing_epochs=args.vae_kl_annealing_epochs if "anneal" in args.mode else 0,
        lr_factor=args.lr_scheduler_factor, lr_patience=args.lr_scheduler_patience,
        early_stopping_patience=args.early_stopping_patience,
        early_stopping_delta=args.early_stopping_delta, seed=args.seed,
        resume=bool(args.resume), mesh=mesh)


def main_uncond(argv=None, device=None):
    """The unconditional DDPM (``train_diffusion_uncond.py``): a
    PUNetG of ``--pixel_diffusion_base_channels`` over the train split's
    label frames, ``--ldm_noise_scheduler_timesteps`` steps, with its EMA,
    into ``<output_dir>/uncond_ddpm/<data_name>``. Runs on the CUDA card
    unless ``device`` names another; with ``device`` None and no card it
    raises. Data parallelism: as ``main_auto``; rank 0 samples the EMA's
    frames. ``--mesh_shape NxM`` splits the PUNetG and its EMA over the
    model axis (tensor parallelism; ``trainer_uncond``). Returns what
    ``train_uncond_ddpm`` returns."""
    args = parse_args(argv)
    check_uncond_flags(args)
    device = entry_device(device)
    set_numerics(args.matmul_precision)
    with open_mesh(args.mesh_shape, device) as mesh, profile_trace(args.profile_dir, device):
        return _run_uncond(args, device, mesh)


def _run_uncond(args: Args, device: torch.device, mesh):
    print(args)
    print(f"[uncond] device: {device}, {mesh}")
    train_data, _, _ = get_auto_dataset(
        data_dir=Path(args.data_dir),
        data_name=args.data_name,
        delta_time=args.delta_time,
        norm_props=bool(args.norm_props),
        norm_bc=bool(args.norm_bc),
        load_splits=["train"],
        seed=args.seed,
        cache_dir=args.cache_dir or None,
    )
    frames = train_data.labels
    print(f"# frames: {frames.shape}")
    return trainer_uncond.train_uncond_ddpm(
        frames, Path(args.output_dir) / "uncond_ddpm" / args.data_name, device=device,
        num_epochs=args.num_epochs, lr=args.lr, batch_size=args.batch_size,
        timesteps=args.ldm_noise_scheduler_timesteps,
        base_channels=args.pixel_diffusion_base_channels, seed=args.seed,
        resume=bool(args.resume), mesh=mesh)
