"""CLI entry points of the port (counterpart of ``cfdbench_tpu/cli.py``).

Only ``main_multistep`` for ``--model fno`` is ported. It takes the
JAX package's flags (the port's copy of them, ``config.Args``) and runs
on the CUDA card; without one it raises. Only a caller that asks for
the CPU (``device="cpu"``, as the tests do) runs there, through the
kernels' plain PyTorch versions. A flag
whose behaviour the port does not have raises and names the ROADMAP.md
item that will bring it; none is ignored silently. ``--use_pallas_head``
changes nothing here: on the card both FNO kernels always run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .config import Args
from .data import load_test_cases
from .data.core import dump_json
from .models import check_model_ported, init_auto_model
from .models.fno import HEAD_WIDTH
from .ops.fno_kernels import check_kernel_shapes, launch_counts
from .training.checkpoints import load_best_params
from .training.rollout import make_rollout_fn, multistep_metrics
from .training.trainer_auto import AutoTask
from .utils.artifacts import get_output_dir, plot_multistep_metrics
from .utils.device import require_cuda, set_f32_numerics

INFER_STEPS = 20


def parse_args(argv=None) -> Args:
    """The JAX package's flags, parsed from ``argv`` (``sys.argv`` when None)."""
    return Args.parse_args(argv)


def run_dir(args: Args) -> Path:
    """The result directory of a run with these flags, where its
    ``ckpt-*`` and ``multistep_metrics.json`` live."""
    return get_output_dir(args, is_auto=True)


def check_supported(args: Args) -> None:
    """Raise on every flag value whose behaviour the port does not have."""
    check_model_ported(args.model)
    if args.rollout_dtype == "bfloat16":
        raise NotImplementedError(
            "--rollout_dtype bfloat16: the port rolls out in float32 only; "
            "bf16 storage is ROADMAP.md A6b"
        )
    if args.rollout_dtype != "float32":
        raise ValueError(
            f"--rollout_dtype {args.rollout_dtype!r}: choose float32 or bfloat16"
        )
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


def main_multistep(argv=None, device=None) -> None:
    """The FNO branch of ``cfdbench_tpu.cli.main_multistep``: a 20-step
    self-feeding rollout of every test case at once from the best
    checkpoint's ``model.pt``, then masked-u mse/nmse/mae per step,
    averaged over cases, into ``multistep_metrics.json``. Runs on the
    CUDA card unless ``device`` names another; with ``device`` None and
    no card it raises. On the card, widths or modes that the kernels
    cannot take on the data's grid raise before the model is built."""
    args = parse_args(argv)
    check_supported(args)
    device = require_cuda() if device is None else torch.device(device)
    set_f32_numerics()
    print(args)
    print(f"[multistep] device: {device}")

    features, case_params = load_test_cases(args, INFER_STEPS)
    if device.type == "cuda":
        check_kernel_shapes(*features.shape[2:4], args.fno_hidden_dim, args.fno_modes_x,
                            args.fno_modes_y, HEAD_WIDTH, args.out_chan)
    frame0 = features[:, 0, :, :, :2]
    mask = features[:, 0, :, :, 2:3]

    output_dir = run_dir(args)
    model = init_auto_model(args, n_case_params=case_params.shape[1], device=device)
    model.load_state_dict(load_best_params(output_dir))
    task = AutoTask(model.eval())

    def on_device(a):
        return torch.as_tensor(
            np.ascontiguousarray(a, np.float32), device=device
        )

    rollout = make_rollout_fn(task.predict_frame, steps=INFER_STEPS)
    before = launch_counts()
    preds = rollout(
        on_device(frame0[..., :task.feedback_channels]),
        on_device(case_params),
        on_device(mask),
    )
    after = launch_counts()
    print("[multistep] kernel launches: " + ", ".join(
        f"{name}={after[name] - before[name]}" for name in after
    ))
    metrics = multistep_metrics(preds, features, mask)
    for m in metrics:
        print(m)
    dump_json(metrics, output_dir / "multistep_metrics.json")
    plot_multistep_metrics(metrics, output_dir / "multistep_metrics.pdf")
