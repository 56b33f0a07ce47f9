"""CLI entry points of the port (counterpart of ``cfdbench_tpu/cli.py``).

- ``main_auto`` (train / test) trains the autoregressive models: ``fno``,
  ``ffno``, ``unet``, ``resnet``, ``auto_ffn``, ``auto_deeponet``,
  ``auto_edeeponet``, ``auto_deeponet_cnn`` and ``pixel_diffusion``.
- ``main_train`` (train / test) trains the non-autoregressive ``ffn``
  and ``deeponet``.
- ``main_gencast`` (train / test) trains GenCast.
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
from .models import (
    DIFFUSION_MODELS,
    NONAUTO_MODELS,
    check_model_ported,
    init_auto_model,
    init_gencast,
    init_nonauto_model,
    init_pixel_diffusion,
)
from .models.fno import HEAD_WIDTH
from .ops.fno_kernels import check_kernel_shapes, launch_counts
from .training import trainer_auto, trainer_gencast, trainer_nonauto
from .training.checkpoints import load_best_params, load_params
from .training.rollout import make_rollout_fn, multistep_metrics
from .training.trainer_auto import AutoTask
from .training.trainer_nonauto import NonAutoTask
from .utils.artifacts import get_output_dir, plot_multistep_metrics
from .utils.device import require_cuda, set_f32_numerics

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
    if args.spectral_backend != "auto":
        raise NotImplementedError(
            f"--spectral_backend {args.spectral_backend}: the DFT-matmul "
            "backends were TPU workarounds and are not ported (ROADMAP.md "
            "A17); the port runs torch.fft on the CPU and the fused kernel "
            "on the card"
        )
    if args.mesh_shape not in ("auto", "1", "1x1"):
        raise NotImplementedError(
            f"--mesh_shape {args.mesh_shape}: the port runs on one device; "
            "parallelism is ROADMAP.md A15"
        )
    if args.compilation_cache_dir:
        raise NotImplementedError(
            "--compilation_cache_dir: the port has no XLA cache; its kernels "
            "are built once into build/cfdbench_tpu_torch (ROADMAP.md A17)"
        )
    if args.matmul_precision not in ("default", "highest"):
        raise NotImplementedError(
            f"--matmul_precision {args.matmul_precision}: the port always "
            "multiplies in full float32 (ROADMAP.md A17)"
        )
    if args.profile_dir:
        raise NotImplementedError(
            "--profile_dir: the port's tracing is ROADMAP.md A7"
        )


def check_rollout_flags(args: Args) -> None:
    """``check_supported`` and the flags only ``main_multistep`` reads."""
    check_supported(args)
    if args.model == "auto_deeponet_cnn":
        raise ValueError(
            "--model auto_deeponet_cnn has no rollout: the point models feed back "
            "their 1-channel u frame (trainer_auto.AutoTask.feedback_channels), and "
            "AutoDeepONetCnn's first conv was built on the 2-channel input plus the "
            "mask and case-parameter planes; the JAX package's main_multistep fails "
            "on the same mismatch (ROADMAP.md C)"
        )
    if args.rollout_dtype == "bfloat16":
        raise NotImplementedError(
            "--rollout_dtype bfloat16: the port rolls out in float32 only; "
            "bf16 storage is ROADMAP.md A6b"
        )
    if args.rollout_dtype != "float32":
        raise ValueError(
            f"--rollout_dtype {args.rollout_dtype!r}: choose float32 or bfloat16"
        )


def check_training_flags(args: Args, regime: str = "auto") -> None:
    """``check_supported`` and the flags only the trainers read:
    ``main_auto``'s (``regime="auto"``), ``main_train``'s (``"nonauto"``)
    or ``main_gencast``'s (``"gencast"``), whose model must be of that
    kind. ``--use_gradient_checkpointing`` is taken where the JAX package
    applies it, by the PUNetG models; ``--gradient_accumulation_steps`` by
    ``main_gencast`` alone."""
    check_supported(args)
    check_model_ported(args.model, regime)
    if args.mode not in ("train", "test", "train_test"):
        raise ValueError(f"--mode {args.mode!r}: choose train, test or train_test")
    if args.pp_microbatches:
        raise NotImplementedError(
            "--pp_microbatches: pipeline parallelism is ROADMAP.md A15"
        )
    if args.shard_spatial:
        raise NotImplementedError(
            "--shard_spatial: spatial sharding is ROADMAP.md A15"
        )
    # Flags the JAX entry point parses and never passes to its trainer
    # (ROADMAP.md C), each with whether this run sets it.
    ignored = {}
    if regime != "gencast":
        ignored[f"--gradient_accumulation_steps {args.gradient_accumulation_steps}"] = (
            args.gradient_accumulation_steps != 1)
    if args.model not in DIFFUSION_MODELS:
        ignored["--use_gradient_checkpointing"] = args.use_gradient_checkpointing
    if regime in ("auto", "gencast") and args.use_mixed_precision:
        raise NotImplementedError(
            "--use_mixed_precision: the port trains in float32 only; bf16 "
            "forwards need bf16 kernel variants (ROADMAP.md A6b)"
        )
    if regime == "auto":
        if args.opt_state_dtype == "factored":
            raise NotImplementedError(
                "--opt_state_dtype factored: adafactor is not ported (ROADMAP.md A18)"
            )
    elif regime == "nonauto":
        ignored.update({
            "--use_mixed_precision": args.use_mixed_precision,
            f"--opt_state_dtype {args.opt_state_dtype}": args.opt_state_dtype != "f32",
            f"--cache_dir {args.cache_dir}": bool(args.cache_dir),
        })
    else:
        ignored.update({
            f"--opt_state_dtype {args.opt_state_dtype}": args.opt_state_dtype != "f32",
            "--measure_time": bool(args.measure_time),
        })
    entry = {"auto": "main_auto", "nonauto": "main_train", "gencast": "main_gencast"}[regime]
    for flag, is_set in ignored.items():
        if is_set:
            raise NotImplementedError(
                f"{flag}: not ported; the JAX {entry} ignores it (ROADMAP.md C)"
            )


def check_fno_kernel_shapes(args: Args, field_shape, device: torch.device) -> None:
    """On the card, raise if the FNO's kernels cannot take its widths and
    modes on the data's grid; the other models run no kernel of ours."""
    if args.model == "fno" and device.type == "cuda":
        check_kernel_shapes(*field_shape, args.fno_hidden_dim, args.fno_modes_x,
                            args.fno_modes_y, HEAD_WIDTH, args.out_chan)


def make_auto_task(args: Args, n_case_params: int, field_shape, device):
    """The task ``main_auto`` trains for ``--model`` (``cfdbench_tpu.cli.make_auto_task``):
    an :class:`AutoTask` around the model, or the pixel-diffusion task."""
    loss_fn = loss_name_to_fn(args.loss_name)
    if args.model == "pixel_diffusion":
        return init_pixel_diffusion(args, n_case_params, loss_fn, device=device)
    model = init_auto_model(args, n_case_params=n_case_params, field_shape=field_shape,
                            device=device)
    return AutoTask(model, loss_fn)


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
    channels)``, on the device."""
    args = parse_args(argv)
    check_rollout_flags(args)
    device = require_cuda() if device is None else torch.device(device)
    set_f32_numerics()
    print(args)
    print(f"[multistep] device: {device}")

    features, case_params = load_test_cases(args, INFER_STEPS)
    field_shape = features.shape[2:4]
    check_fno_kernel_shapes(args, field_shape, device)
    frame0 = features[:, 0, :, :, :2]
    mask = features[:, 0, :, :, 2:3]
    output_dir = run_dir(args)

    def on_device(a):
        return torch.as_tensor(
            np.ascontiguousarray(a, np.float32), device=device
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
        task.model.load_state_dict(load_params(output_dir / trainer_gencast.BEST_DIR))
        f0 = on_device(frame0)
        preds = task.rollout(f0, f0, on_device(case_params), on_device(mask), INFER_STEPS)
    else:
        task = make_auto_task(args, P, field_shape, device)
        task.model.load_state_dict(load_best_params(output_dir))
        task.model.eval()
        rollout = make_rollout_fn(task.predict_frame, steps=INFER_STEPS,
                                  include_initial=(args.model == "resnet"),
                                  stochastic=task.generative, seed=args.seed)
        preds = rollout(
            on_device(frame0[..., :task.feedback_channels]),
            on_device(case_params),
            on_device(mask),
        )
    print_launches("multistep", before)
    metrics = multistep_metrics(preds, features, mask)
    for m in metrics:
        print(m)
    dump_json(metrics, output_dir / "multistep_metrics.json")
    plot_multistep_metrics(metrics, output_dir / "multistep_metrics.pdf")
    return preds


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


def main_auto(argv=None, device=None) -> None:
    """The autoregressive branch of ``cfdbench_tpu.cli.main_auto``
    (``src/train_auto.py:316-378``): ``--mode train`` trains with Adam
    and StepLR and writes ``ckpt-{ep}/`` per eval epoch, ``test`` scores
    the best checkpoint on the test split, ``train_test`` does both.
    Pixel diffusion is scored on the frames it generates, its dev
    evaluation on at most ``--max_eval_batches`` batches.
    Runs on the CUDA card unless ``device`` names another; with
    ``device`` None and no card it raises. On the card, FNO widths or
    modes that its kernels cannot take on the data's grid raise before
    the model is built."""
    args = parse_args(argv)
    check_training_flags(args, "auto")
    device = require_cuda() if device is None else torch.device(device)
    set_f32_numerics()
    print("#" * 80)
    print(args)
    print("#" * 80)
    print(f"[auto] device: {device}")

    output_dir = run_dir(args)
    output_dir.mkdir(parents=True, exist_ok=True)
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
    task = make_auto_task(args, ref.n_case_params, ref.field_shape, device)
    model = task.model

    if "train" in args.mode:
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
        )
        print_launches("train", before)
        if args.measure_time:
            # A micro-benchmark: print ms/step and stop (src/train.py:94-100).
            return
    if "test" in args.mode:
        args.save(output_dir / "test_args.json")
        model.load_state_dict(load_best_params(output_dir))
        before = launch_counts()
        trainer_auto.test(task, test_data, output_dir / "test", device=device,
                          batch_size=1, plot_interval=10)
        print_launches("test", before)


def main_train(argv=None, device=None) -> None:
    """``cfdbench_tpu.cli.main_train`` (``src/train.py:295-350``) for the
    non-autoregressive ``ffn`` and ``deeponet``: ``--mode train`` trains
    with Adam and StepLR on 1000 sampled lattice points a step and
    writes ``ckpt-{ep}/`` per eval epoch under ``non-auto/``, ``test``
    scores the best checkpoint's whole-lattice frames on the test split,
    ``train_test`` does both. Runs on the CUDA card unless ``device``
    names another; with ``device`` None and no card it raises.
    ``--eval_batch_size`` and ``--plot_train_examples`` are ignored, as
    in the JAX package."""
    args = parse_args(argv)
    check_training_flags(args, "nonauto")
    device = require_cuda() if device is None else torch.device(device)
    set_f32_numerics()
    print("#" * 80)
    print(args)
    print("#" * 80)
    print(f"[train] device: {device}")

    output_dir = run_dir(args)
    output_dir.mkdir(parents=True, exist_ok=True)
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

    if "train" in args.mode:
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
            return
    if "test" in args.mode:
        args.save(output_dir / "test_args.json")
        model.load_state_dict(load_best_params(output_dir))
        trainer_nonauto.test(task, test_data, output_dir / "test", device=device, batch_size=1)


def main_gencast(argv=None, device=None) -> None:
    """``cfdbench_tpu.cli.main_gencast`` (``src/train_gencast.py``): GenCast
    on (X_{t−2}, X_{t−1}, X_t) triples of the auto dataset, whatever
    ``--model`` says, into the ``gencast`` run directory. The residual
    statistics are read from its ``residual_stats.npz``, or computed on
    the train split and cached there when it is missing (the reference
    requires the file). ``--mode train`` trains (AdamW, warmup-cosine,
    ``--gradient_accumulation_steps``, ``--use_gradient_checkpointing``)
    and resumes whenever a ``training_state/`` is there, as the JAX entry
    point does; ``test`` generates and scores the test split from
    ``best_model/``; ``train_test`` does both. Runs on the CUDA card
    unless ``device`` names another; with ``device`` None and no card it
    raises."""
    args = dataclasses.replace(parse_args(argv), model="gencast")
    check_training_flags(args, "gencast")
    device = require_cuda() if device is None else torch.device(device)
    set_f32_numerics()
    print(args)
    print(f"[gencast] device: {device}")
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
    if stats_path.exists():
        stats = load_residual_stats(stats_path)
    else:
        stats = compute_residual_stats(gc_train)
        save_residual_stats(stats, stats_path)
        print(f"Residual stats computed and cached at {stats_path}")
    print(f"residual mean={stats['residual_mean']}, std={stats['residual_std']}")
    task = init_gencast(args, stats, gc_train.n_case_params, loss_name_to_fn(args.loss_name),
                        device=device)
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


def print_launches(what: str, before: dict) -> None:
    after = launch_counts()
    print(f"[{what}] kernel launches: " + ", ".join(
        f"{name}={after[name] - before[name]}" for name in after))
