"""CLI entry points of the port (counterpart of ``cfdbench_tpu/cli.py``).

- ``main_auto`` (train / test) trains the autoregressive models: ``fno``,
  ``ffno``, ``unet``, ``resnet``, ``auto_ffn``, ``auto_deeponet``,
  ``auto_edeeponet`` and ``auto_deeponet_cnn``.
- ``main_train`` (train / test) trains the non-autoregressive ``ffn``
  and ``deeponet``.
- ``main_multistep`` rolls out either kind: a self-feeding rollout for
  the autoregressive models (``auto_deeponet_cnn``'s raises, as the JAX
  package's does), one whole-lattice generation a step for the others.

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

from pathlib import Path

import numpy as np
import torch

from .config import Args
from .data import get_auto_dataset, get_dataset, load_test_cases
from .data.core import dump_json
from .metrics import loss_name_to_fn
from .models import NONAUTO_MODELS, check_model_ported, init_auto_model, init_nonauto_model
from .models.fno import HEAD_WIDTH
from .ops.fno_kernels import check_kernel_shapes, launch_counts
from .training import trainer_auto, trainer_nonauto
from .training.checkpoints import load_best_params
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
    ``main_auto``'s (``regime="auto"``) or ``main_train``'s
    (``"nonauto"``), whose model must be of that kind."""
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
    ignored = {
        f"--gradient_accumulation_steps {args.gradient_accumulation_steps}":
            args.gradient_accumulation_steps != 1,
        "--use_gradient_checkpointing": args.use_gradient_checkpointing,
    }
    if regime == "auto":
        if args.use_mixed_precision:
            raise NotImplementedError(
                "--use_mixed_precision: the port trains in float32 only; bf16 "
                "forwards need bf16 kernel variants (ROADMAP.md A6b)"
            )
        if args.opt_state_dtype == "factored":
            raise NotImplementedError(
                "--opt_state_dtype factored: adafactor is not ported (ROADMAP.md A18)"
            )
    else:
        ignored.update({
            "--use_mixed_precision": args.use_mixed_precision,
            f"--opt_state_dtype {args.opt_state_dtype}": args.opt_state_dtype != "f32",
            f"--cache_dir {args.cache_dir}": bool(args.cache_dir),
        })
    entry = "main_auto" if regime == "auto" else "main_train"
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


def main_multistep(argv=None, device=None) -> torch.Tensor:
    """``cfdbench_tpu.cli.main_multistep`` (``src/test_multistep.py``):
    20 frames of every test case at once from the best checkpoint's
    ``model.pt``, then masked-u mse/nmse/mae per step, averaged over
    cases, into the run's ``multistep_metrics.json``.

    An autoregressive model rolls out, feeding back its own prediction;
    the ResNet's frames are ``[frame0, pred_1, …, pred_19]``
    (``include_initial``, as the JAX package aligns them); the point
    models feed back u alone. A non-autoregressive model generates each
    step's frame, ``t = s`` for s in 0..19, in one whole-lattice call
    over all cases (``test_multistep.py:119-132``), from its
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
    if args.model in NONAUTO_MODELS:
        model = init_nonauto_model(args, n_case_params=case_params.shape[1], device=device)
        model.load_state_dict(load_best_params(output_dir))
        preds = generate_steps(NonAutoTask(model.eval()), on_device(case_params),
                               field_shape, INFER_STEPS)
    else:
        model = init_auto_model(args, n_case_params=case_params.shape[1],
                                field_shape=field_shape, device=device)
        model.load_state_dict(load_best_params(output_dir))
        task = AutoTask(model.eval())
        rollout = make_rollout_fn(task.predict_frame, steps=INFER_STEPS,
                                  include_initial=(args.model == "resnet"))
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
    model = init_auto_model(args, n_case_params=ref.n_case_params, field_shape=ref.field_shape,
                            device=device)
    task = AutoTask(model, loss_name_to_fn(args.loss_name))

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


def print_launches(what: str, before: dict) -> None:
    after = launch_counts()
    print(f"[{what}] kernel launches: " + ", ".join(
        f"{name}={after[name] - before[name]}" for name in after))
