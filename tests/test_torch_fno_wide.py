"""The FNO past the kernels' old shared-memory limits, against the JAX
package: the port's ``Fno2d`` with its block and head launched through the
kernels' CPU emulation (``ops/_build.py::load_emulation``; ``FnoBlockFn``
and ``FnoHeadFn`` under grad), on the same numpy-seeded inputs and weights
as JAX's ``Fno2d``, its Pallas block route (``fno2d_apply_pallas``) and its
Pallas head route (``fno2d_apply_pallas_head``), both in interpret mode.
Depth 1, two configurations: widths 160 and 256 on 16x16 (the head's fc1
streamed over the channels) and width 32 on 8x512 (the block's
inverse-columns pass tiled over eight column tiles). Forwards within 2e-5,
gradients within 1e-5 of each one's largest."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.models.fno import fno2d_apply_pallas, fno2d_apply_pallas_head
from cfdbench_tpu_torch import metrics
from cfdbench_tpu_torch.models import fno
from cfdbench_tpu_torch.models.fno import Fno2d
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.utils.flax_import import params_from_flax
from tests.test_torch_kernels import emulation, t

torch.set_num_threads(1)

P = 5
FORWARD_ATOL = 2e-5
GRAD_RTOL = 1e-5  # of each gradient's largest element
# (batch, grid, width, modes)
CASES = {"h160": (2, (16, 16), 160, 3), "h256": (2, (16, 16), 256, 3),
         "w512": (1, (8, 512), 32, 12)}


def batch(rng, B, H, W):
    mask = (rng.uniform(size=(B, H, W, 1)) > 0.2).astype(np.float32)
    return (rng.standard_normal((B, H, W, 2)).astype(np.float32),
            rng.standard_normal((B, P)).astype(np.float32), mask,
            rng.standard_normal((B, H, W, 2)).astype(np.float32))


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """JAX's forward, its two Pallas routes' and its loss and gradients;
    the port's through the emulated kernels (the shapes each launch got)."""
    B, (H, W), width, modes = CASES[request.param]
    rng = np.random.default_rng(0)
    x, cp, mask, label = batch(rng, B, H, W)
    widths = dict(num_layers=1, hidden_dim=width, modes1=modes, modes2=modes)
    jax_model = JaxFno2d(in_chan=2, out_chan=2, n_case_params=P, **widths)
    init = jax.jit(jax_model.init)
    params = jax.device_get(init(jax.random.PRNGKey(0), x, cp, mask)["params"])
    # Spectral weights at `width` times their init scale, so the spectral
    # path carries as much of the output as the bypass.
    spec = params["FnoBlock_0"]["SpectralConv2d_0"]
    spec["weights"] = np.asarray(spec["weights"]) * width

    def jax_nmse(p):
        preds = jax_model.apply({"params": p}, x, cp, mask)
        return jax_loss_name_to_fn("nmse")(preds, label * mask)["nmse"], preds

    (loss_j, want), grads_j = jax.jit(jax.value_and_grad(jax_nmse, has_aux=True))(params)
    args = (jnp.asarray(x), jnp.asarray(cp), jnp.asarray(mask))
    pallas = {"block": fno2d_apply_pallas(jax_model, params, *args, interpret=True),
              "head": fno2d_apply_pallas_head(jax_model, params, *args, interpret=True)}

    model = Fno2d(in_chan=2, out_chan=2, n_case_params=P, **widths,
                  generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(params))
    lib, shapes = emulation(), []

    def block(x, weights, w0, b0, m1, m2, rows=None, tf32=False):
        shapes.append(("block", tuple(x.shape)))
        return fk.FnoBlockFn.apply(lib, 0, True, x, weights, w0, b0, m1, m2, None, tf32)

    def head(x, w1, b1, w2, b2, mask, tf32=False):
        shapes.append(("head", tuple(x.shape)))
        return fk.FnoHeadFn.apply(lib, 0, x, w1, b1, w2, b2, mask, tf32)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(fno, "block_call", block)
        m.setattr(fno, "head_call", head)
        preds = model(t(x), t(cp), t(mask))
    loss = metrics.loss_name_to_fn("nmse")(preds, t(label * mask))["nmse"]
    loss.backward()
    return dict(
        shape=(B, H, W, width), shapes=shapes, want=np.asarray(want),
        pallas={k: np.asarray(v) for k, v in pallas.items()}, got=preds.detach().numpy(),
        loss=(loss.item(), float(loss_j)), grads={k: p.grad for k, p in model.named_parameters()},
        want_grads=params_from_flax(jax.device_get(grads_j)))


def test_wide_model_runs_every_block_and_head_through_the_kernels(run):
    B, H, W, width = run["shape"]
    assert run["shapes"] == [("block", (B, H, W, width)), ("head", (B, H, W, width))]
    assert np.isfinite(run["got"]).all() and run["got"].shape == (B, H, W, 2)


def test_wide_forward_matches_jax(run):
    np.testing.assert_allclose(run["got"], run["want"], rtol=0, atol=FORWARD_ATOL)


@pytest.mark.parametrize("route", ["block", "head"])
def test_wide_forward_matches_the_pallas_routes(run, route):
    np.testing.assert_allclose(run["got"], run["pallas"][route], rtol=0, atol=FORWARD_ATOL)


def test_wide_gradients_match_jax(run):
    got, want = run["loss"]
    assert math.isclose(got, want, rel_tol=1e-5)
    assert set(run["grads"]) == set(run["want_grads"])
    for k, g in run["grads"].items():
        w = run["want_grads"][k]
        assert g is not None and (g - w).abs().max() <= GRAD_RTOL * w.abs().max(), k
