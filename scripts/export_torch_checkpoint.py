#!/usr/bin/env python
"""Carry a trained JAX checkpoint over to the PyTorch port: an
autoregressive model's run (``auto/...``, ``train_auto.py``, pixel
diffusion included), a GenCast run (``train_gencast.py``: ``--model
gencast``) or a non-autoregressive one's (``non-auto/...``, ``train.py``:
``--model ffn`` or ``deeponet``).

Loads the best checkpoint of a JAX run (an Orbax ``ckpt-*/model/`` or a
``model.msgpack``, the one with the lowest dev loss; GenCast's
``best_model/``) with ``cfdbench_tpu.training.checkpoints`` and writes
``model.pt`` beside it, in the port's state-dict layout
(``cfdbench_tpu_torch/utils/flax_import.py``): the parameters and, for
the U-Net, its BatchNorm running statistics as buffers. Run it where JAX
is installed, with the run's own flags (the point models' sizes follow
``--num_rows``/``--num_cols``, the grid they were trained on):

    python scripts/export_torch_checkpoint.py --model fno \
        --data_name cavity_prop_bc_geo --output_dir result \
        [--fno_depth 4 --fno_hidden_dim 32 --fno_modes_x 12 --fno_modes_y 12]
    python test_multistep_torch.py --model fno --data_name cavity_prop_bc_geo \
        --data_dir <data> --output_dir result
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from cfdbench_tpu.cli import make_auto_task  # noqa: E402
from cfdbench_tpu.config import Args  # noqa: E402
from cfdbench_tpu.data.wrapper import load_residual_stats  # noqa: E402
from cfdbench_tpu.metrics import loss_name_to_fn  # noqa: E402
from cfdbench_tpu.models.diffusion import GenCastCfdModel  # noqa: E402
from cfdbench_tpu.models import (  # noqa: E402
    get_input_shapes,
    init_auto_model,
    init_nonauto_model,
)
from cfdbench_tpu.training.checkpoints import (  # noqa: E402
    get_best_ckpt,
    load_best_params,
    load_params,
)
from cfdbench_tpu.utils.artifacts import get_output_dir  # noqa: E402
from cfdbench_tpu_torch.models import NONAUTO_MODELS, check_model_ported  # noqa: E402
from cfdbench_tpu_torch.training.checkpoints import save_params  # noqa: E402
from cfdbench_tpu_torch.utils.flax_import import params_from_flax  # noqa: E402


def main(argv=None) -> Path:
    args = Args.parse_args(argv)
    check_model_ported(args.model)
    is_auto = args.model not in NONAUTO_MODELS
    run_dir = get_output_dir(args, is_auto=is_auto)
    H, W, P = get_input_shapes(args)
    if args.model in ("pixel_diffusion", "gencast"):
        return export_diffusion(args, run_dir, H, W, P)
    if is_auto:
        model = init_auto_model(args, n_case_params=P)
        sample = (
            np.zeros((1, H, W, args.in_chan), np.float32),
            np.zeros((1, P), np.float32),
            np.ones((1, H, W, 1), np.float32),
        )
    else:
        model = init_nonauto_model(args, n_case_params=P)
        sample = (np.zeros((1, P), np.float32), np.zeros((1, 1), np.float32),
                  np.zeros((4, 2), np.float32))
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *sample)
    )
    variables = jax.device_get(dict(load_best_params(template, run_dir)))
    path = save_params(
        params_from_flax(variables["params"], variables.get("batch_stats")),
        get_best_ckpt(run_dir),
    )
    print(f"wrote {path}")
    return path


def export_diffusion(args: Args, run_dir: Path, H: int, W: int, P: int) -> Path:
    """A PUNetG run: pixel diffusion's best ``ckpt-*``, or GenCast's
    ``best_model/`` (its task needs the run's ``residual_stats.npz``)."""
    frame = np.zeros((1, H, W, args.out_chan), np.float32)
    sample = dict(inputs=frame, inputs_prev=frame, labels=frame,
                  case_params=np.zeros((1, P), np.float32))
    if args.model == "pixel_diffusion":
        task = make_auto_task(args, n_case_params=P, field_shape=(H, W))
        template = jax.eval_shape(lambda: task.init_params(jax.random.PRNGKey(0), sample))
        params = load_best_params(template, run_dir)["params"]
        target = get_best_ckpt(run_dir)
    else:
        task = GenCastCfdModel(
            loss_name_to_fn(args.loss_name),
            **load_residual_stats(run_dir / "residual_stats.npz"),
            in_chan=args.in_chan, out_chan=args.out_chan, n_case_params=P,
            noise_scheduler_timesteps=args.ldm_noise_scheduler_timesteps,
            base_channels=args.pixel_diffusion_base_channels,
            channel_mults=tuple(args.pixel_diffusion_channel_mults),
            num_res_blocks=args.pixel_diffusion_num_res_blocks,
            dropout=args.pixel_diffusion_dropout,
        )
        template = jax.eval_shape(
            lambda: task.init_variables(jax.random.PRNGKey(0), sample)[0])
        target = run_dir / "best_model"
        params = load_params({"params": template}, target)["params"]
    path = save_params(params_from_flax(jax.device_get(dict(params))), target)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    # A host-side conversion: stay off any accelerator plugin.
    jax.config.update("jax_platforms", "cpu")
    main()
