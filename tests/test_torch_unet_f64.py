"""The port's U-Net against the JAX package's in float64: the train-mode
forward and every gradient of one process at the 32x32 batch of 4 of
``tests/test_torch_sp_models.py``, within 1e-10.

In float32 the two part by 1.2e-4 in the forward and 4.4e-5 of the
largest gradient (``tests/test_torch_sp_models.py``): the BatchNorms
normalise the 2x2 bottleneck over 16 values a channel (a batch of 4), where
the float32 rounding of the batch statistics is amplified by 1/std. In
float64 the same step parts by 2.6e-13 in the forward (its largest value
4.1) and 6.2e-14 of the largest gradient, so the float32 gap is rounding,
not a difference in what the two compute. JAX computes in float64 within
the scoped ``jax.enable_x64(True)`` only (this JAX's form of
``jax.experimental.enable_x64``), so the other tests of a worker stay
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models.unet import UNet as JaxUNet
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu_torch.metrics import loss_name_to_fn
from cfdbench_tpu_torch.utils.flax_import import (
    batch_stats_to_flax, params_to_flax)
from tests import _torch_dp_worker as worker

torch.set_num_threads(1)

F64_ATOL = 1e-10  # the forward, absolute; the gradients, of the largest


def test_unet_float64_step_matches_jax():
    rng = np.random.default_rng(0)
    batch = {k: v.astype(np.float64)
             for k, v in worker.global_batch(rng, 4, 32, 32, valid=3).items()}
    task = worker.make_task("unet", dict(dim=4), loss_name_to_fn("nmse"))
    model = task.model.double().train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(b["inputs"], b["case_params"], b["mask"])
    loss = task.loss_fn(out, b["labels"] * b["mask"], sample_weights=b["weights"])["nmse"]
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}

    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)

        jax_task = JaxAutoTask(JaxUNet(in_chan=2, out_chan=2, n_case_params=5, dim=4),
                               jax_loss_name_to_fn("nmse"))
        params = f64(params_to_flax(state))
        model_state = {"batch_stats": f64(batch_stats_to_flax(state))}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def jax_loss(p):
            preds, _ = jax_task._forward(p, model_state, jb, True, None)
            scores = jax_task.loss_fn(preds, jb["labels"] * jb["mask"],
                                      sample_weights=jb["weights"])
            return scores["nmse"], preds

        jax_grads, preds = jax.jit(jax.grad(jax_loss, has_aux=True))(params)
        assert preds.dtype == jnp.float64
        preds = torch.from_numpy(np.asarray(preds))
        want = jax.device_get(jax_grads)
    assert out.dtype == torch.float64
    assert (out.detach() - preds).abs().max().item() <= F64_ATOL
    # Compared in flax's layout, which keeps float64 (the loader casts to
    # float32).
    got = params_to_flax(grads)
    pairs = list(zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    assert jax.tree.structure(got) == jax.tree.structure(want) and pairs
    top = max(np.abs(w).max() for _, w in pairs)
    for g, w in pairs:
        assert w.dtype == np.float64
        assert np.abs(g - w).max() <= F64_ATOL * top
