#!/usr/bin/env python
"""Export a trained checkpoint as serving artifacts (``torch.export``;
port of ``scripts/export_model.py``).

Loads the best checkpoint of the run in the standard result tree (the
lowest ``dev_loss`` over ``ckpt-*/scores.json``, as ``--mode test``
picks it) and writes ``<run>/serve/predict.pt2`` and ``rollout.pt2``:
the next-frame function and the 20-step rollout at the test split's
grid, ``--batch_size`` cases a call, weights included. A serving process
needs only ``torch``, the port's operator registrations and the artifact
(``cfdbench_tpu_torch.utils.export.load_exported``). The artifacts run
on the device they were exported on: the card, unless ``--device cpu``.
An ``auto_deeponet_cnn`` run gets no ``rollout.pt2``: the model has no
rollout (ROADMAP.md C).

A diffusion run (``pixel_diffusion``, ``latent_diffusion``,
``latent_diffusion2``, ``latent_diffusion_lite``) exports its DDPM
sampler, ``--ldm_num_inference_steps`` or the pixel model's 50 steps, as
one loop inside each artifact; a latent run's frozen VAE, read from
``--ldm_vae_weights_path`` as ``main_auto`` reads it, rides along. Its
artifacts take the sampler's noise as a fourth input, and draw it
themselves when called without it, as ``main_multistep`` does at
``--seed 0`` (``utils/export.py``). GenCast, trained by ``main_gencast``,
has no ``predict_frame`` and no export, as in the JAX package.

Usage mirrors the trainers:
    python scripts/export_model_torch.py --model fno \\
        --data_name cavity_prop_bc_geo --data_dir <root> \\
        --output_dir <result root> --batch_size 128
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import torch  # noqa: E402

STEPS = 20  # the rollout's length, main_multistep's


def main(argv=None) -> Path:
    """Write the artifacts; returns the ``serve/`` directory."""
    from cfdbench_tpu_torch.cli import (
        check_fno_kernel_shapes, check_supported, make_auto_task, run_dir,
    )
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.data import get_auto_dataset
    from cfdbench_tpu_torch.models.point import NO_ROLLOUT
    from cfdbench_tpu_torch.training.checkpoints import load_best_params
    from cfdbench_tpu_torch.utils.device import require_cuda, set_numerics
    from cfdbench_tpu_torch.utils.export import export_predict, export_rollout

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="device to export for (default: the CUDA card; cpu for tests)")
    ns, rest = pre.parse_known_args(argv)
    args = Args.parse_args(rest)
    check_supported(args)
    if args.model == "gencast":
        raise ValueError("--model gencast: GenCast generates from two frames and has no "
                         "predict_frame, so it has no export, in the JAX package either "
                         "(ROADMAP.md C)")
    device = require_cuda() if ns.device is None else torch.device(ns.device)
    set_numerics(args.matmul_precision)
    _, _, test_data = get_auto_dataset(
        data_dir=Path(args.data_dir),
        data_name=args.data_name,
        delta_time=args.delta_time,
        norm_props=bool(args.norm_props),
        norm_bc=bool(args.norm_bc),
        load_splits=["test"],
        seed=args.seed,
        cache_dir=args.cache_dir or None,
    )
    H, W = test_data.field_shape
    P = test_data.n_case_params
    check_fno_kernel_shapes(args, (H, W), device)
    task = make_auto_task(args, P, (H, W), device)
    output_dir = run_dir(args)
    task.model.load_state_dict(load_best_params(output_dir))

    serve = output_dir / "serve"
    B = args.batch_size
    n = export_predict(task, serve / "predict.pt2", B, H, W, P, device=device)
    print(f"wrote {serve}/predict.pt2 ({n} bytes)")
    if args.model == "auto_deeponet_cnn":
        print(f"no rollout.pt2: {NO_ROLLOUT}")
    else:
        n = export_rollout(task, serve / "rollout.pt2", B, H, W, P, steps=STEPS, device=device)
        print(f"wrote {serve}/rollout.pt2 ({n} bytes)")
    return serve


if __name__ == "__main__":
    main()
