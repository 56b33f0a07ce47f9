#!/usr/bin/env python
"""Carry a trained JAX checkpoint over to the PyTorch port: an
autoregressive model's run (``auto/...``, ``train_auto.py``) or a
non-autoregressive one's (``non-auto/...``, ``train.py``: ``--model ffn``
or ``deeponet``).

Loads the best checkpoint of a JAX run (an Orbax ``ckpt-*/model/`` or a
``model.msgpack``, the one with the lowest dev loss) with
``cfdbench_tpu.training.checkpoints.load_best_params`` and writes
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

from cfdbench_tpu.config import Args  # noqa: E402
from cfdbench_tpu.models import (  # noqa: E402
    get_input_shapes,
    init_auto_model,
    init_nonauto_model,
)
from cfdbench_tpu.training.checkpoints import (  # noqa: E402
    get_best_ckpt,
    load_best_params,
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


if __name__ == "__main__":
    # A host-side conversion: stay off any accelerator plugin.
    jax.config.update("jax_platforms", "cpu")
    main()
