"""``Fno2d(padding=p)``, the FNO's domain padding, against the JAX
package's on the same numpy-seeded inputs and weights (16x16, width 8,
two layers; ``p`` 2 at 4 modes and 3 at 12, which clamp on the padded
grid): the forward against ``Fno2d(padding=p)`` and its Pallas
route in interpret mode (``fno2d_apply_pallas``), 2e-5; the gradients,
1e-5 of their largest; three Adam steps through ``trainer_auto.train_step``
and a 5-step rollout; the served predict against the in-process one; a
``1x2`` tensor-parallel step on gloo ranks against JAX and one process; the
pipeline's refusal, and spatial sharding's taking it (its steps:
``tests/test_torch_sp_padded.py``). The kernels' path on the CPU: the
model's own forward with every block and the head launched through the
kernels' CPU emulation (``FnoBlockFn``, ``FnoHeadFn``), and the block at an
odd padded grid wider than 64 (73x73, the flagship's 64x64 padded by 9)."""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.models.fno import fno2d_apply_pallas
from cfdbench_tpu.training.optim import make_adam as jax_make_adam
from cfdbench_tpu.training.rollout import make_rollout_fn as jax_make_rollout_fn
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu.training.trainer_auto import TrainState, make_train_step
from cfdbench_tpu_torch import metrics
from cfdbench_tpu_torch.models import fno
from cfdbench_tpu_torch.models.fno import Fno2d, fno2d_reference
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.parallel.mesh import DataMesh, ModelAxis
from cfdbench_tpu_torch.parallel.pipeline import PipelineStage
from cfdbench_tpu_torch.training.optim import make_adam
from cfdbench_tpu_torch.training.rollout import make_rollout_fn
from cfdbench_tpu_torch.training.trainer_auto import AutoTask, split_model, train_step
from cfdbench_tpu_torch.utils.export import export_predict, load_exported
from cfdbench_tpu_torch.utils.flax_import import params_from_flax
from tests import _torch_dp_worker as worker
from tests.test_torch_kernels import check_block_with_saved, emulation, kernel_case, t
from tests.test_torch_tp import LOSS_RTOL, LR, MIN_SIZE, PARAM_ATOL, assert_step, jax_step

torch.set_num_threads(1)

B, H, W, P = 2, 16, 16, 5
FORWARD_ATOL = 2e-5
GRAD_RTOL = 1e-5  # of each gradient's largest element
STEP_ATOL = 1e-5
ROLLOUT_RTOL = 1e-4  # of the frames' largest
ADAM_STEPS = 3
ROLLOUT_STEPS = 5
# (padding, modes): an even pad at 4 modes, and an odd one at 12 modes,
# which the padded 19x19 grid clamps to 9 and 10 (the data's 16x16 to 8
# and 9).
CASES = [(2, 4), (3, 12)]


def widths(padding, modes):
    return dict(num_layers=2, hidden_dim=8, modes1=modes, modes2=modes, padding=padding)


def both_models(padding, modes):
    """The JAX model with its parameters, and the port's on the same weights."""
    jax_model = JaxFno2d(in_chan=2, out_chan=2, n_case_params=P, **widths(padding, modes))
    x, cp, mask, _ = batch(np.random.default_rng(1), 1)
    params = jax.device_get(jax_model.init(jax.random.PRNGKey(0), x, cp, mask)["params"])
    model = Fno2d(in_chan=2, out_chan=2, n_case_params=P, **widths(padding, modes),
                  generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(params))
    return jax_model, params, model


def batch(rng, n=B):
    mask = (rng.uniform(size=(n, H, W, 1)) > 0.2).astype(np.float32)
    return (rng.standard_normal((n, H, W, 2)).astype(np.float32),
            rng.standard_normal((n, P)).astype(np.float32), mask,
            rng.standard_normal((n, H, W, 2)).astype(np.float32))


def jax_nmse(jax_model, params, x, cp, mask, label):
    preds = jax_model.apply({"params": params}, x, cp, mask)
    return jax_loss_name_to_fn("nmse")(preds, label * mask)["nmse"]


@pytest.mark.parametrize("padding,modes", CASES)
def test_padded_forward_matches_jax_and_its_pallas_route(rng, padding, modes):
    jax_model, params, model = both_models(padding, modes)
    x, cp, mask, _ = batch(rng)
    want = np.asarray(jax_model.apply({"params": params}, x, cp, mask))
    pallas = np.asarray(fno2d_apply_pallas(jax_model, params, jnp.asarray(x), jnp.asarray(cp),
                                           jnp.asarray(mask), interpret=True))
    with torch.inference_mode():
        got = model(t(x), t(cp), t(mask))
        plain = fno2d_reference(model, t(x), t(cp), t(mask))
    assert got.shape == (B, H, W, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FORWARD_ATOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=FORWARD_ATOL)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    # The padding is not a no-op at these weights.
    with torch.inference_mode():
        model.padding = None
        unpadded = model(t(x), t(cp), t(mask))
    assert (unpadded - got).abs().max().item() > 1e-3


@pytest.mark.parametrize("padding,modes", CASES)
def test_padded_gradients_match_jax(rng, padding, modes):
    jax_model, params, model = both_models(padding, modes)
    x, cp, mask, label = batch(rng)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_nmse(jax_model, p, x, cp, mask, label))(params)
    loss = metrics.loss_name_to_fn("nmse")(model(t(x), t(cp), t(mask)), t(label * mask))["nmse"]
    loss.backward()
    assert math.isclose(loss.item(), float(loss_j), rel_tol=1e-5)
    want = params_from_flax(jax.device_get(grads_j))
    for k, p in model.named_parameters():
        assert (p.grad - want[k]).abs().max() <= GRAD_RTOL * want[k].abs().max(), k


@pytest.mark.parametrize("padding,modes", CASES)
def test_padded_adam_steps_match_jax(rng, padding, modes):
    jax_model, params, model = both_models(padding, modes)
    batches = [batch(rng) for _ in range(ADAM_STEPS)]
    jax_task = JaxAutoTask(jax_model, jax_loss_name_to_fn("nmse"))
    tx = jax_make_adam(LR, steps_per_epoch=10)
    state = TrainState(params, {}, tx.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(jax_task, tx, seed=0)
    task = AutoTask(model, metrics.loss_name_to_fn("nmse"))
    opt, sched = make_adam(model.parameters(), LR, steps_per_epoch=10)
    for x, cp, mask, label in batches:
        as_dict = dict(inputs=x, case_params=cp, mask=mask, labels=label,
                       weights=np.ones(B, np.float32))
        state, scores_j = step(state, {k: jnp.asarray(v) for k, v in as_dict.items()})
        scores = train_step(task, opt, sched, {k: t(v) for k, v in as_dict.items()})
        assert math.isclose(float(scores["nmse"]), float(scores_j["nmse"]), rel_tol=LOSS_RTOL)
    want = params_from_flax(jax.device_get(state.params))
    for k, p in model.named_parameters():
        assert (p.detach() - want[k]).abs().max().item() <= STEP_ATOL, k


@pytest.mark.parametrize("padding,modes", CASES)
def test_padded_rollout_matches_jax(rng, padding, modes):
    jax_model, params, model = both_models(padding, modes)
    x, cp, mask, _ = batch(rng)
    roll = jax_make_rollout_fn(lambda p, f, c, m: jax_model.apply({"params": p}, f, c, m),
                               ROLLOUT_STEPS)
    want = np.asarray(roll(params, x, cp, mask))
    with torch.inference_mode():
        got = make_rollout_fn(model.eval(), ROLLOUT_STEPS)(t(x), t(cp), t(mask)).numpy()
    assert got.shape == want.shape == (ROLLOUT_STEPS, B, H, W, 2)
    assert np.abs(got - want).max() <= ROLLOUT_RTOL * np.abs(want).max()


def test_padded_export_serves_the_in_process_predict(tmp_path, rng):
    _, _, model = both_models(3, 4)
    task = AutoTask(model.eval())
    x, cp, mask, _ = batch(rng)
    export_predict(task, tmp_path / "p.pt2", B, H, W, P, device="cpu")
    with torch.inference_mode():
        got = load_exported(tmp_path / "p.pt2")(t(x), t(cp), t(mask))
        live = task.predict_frame(t(x), t(cp), t(mask))
    torch.testing.assert_close(got, live, rtol=0, atol=0)


def test_padded_forward_through_the_kernels_in_emulation(rng, monkeypatch):
    """The padded model's own forward with every block and the head
    launched through the kernels' CPU emulation, under grad: the blocks at
    the padded 19x19 grid, the head on the cropped 16x16 field (which it
    reads as a dense copy). Predictions and every gradient against autograd
    through the plain versions."""
    lib = emulation()
    _, _, model = both_models(3, 4)
    with torch.no_grad():
        for blk in model.blocks:  # the spectral path as large as the bypass
            blk.weights.mul_(8)
    shapes = []

    def block(x, weights, w0, b0, m1, m2, rows=None, tf32=False):
        shapes.append(("block", tuple(x.shape)))
        return fk.FnoBlockFn.apply(lib, 0, True, x, weights, w0, b0, m1, m2, None, tf32)

    def head(x, w1, b1, w2, b2, mask, tf32=False):
        shapes.append(("head", tuple(x.shape), x.is_contiguous()))
        return fk.FnoHeadFn.apply(lib, 0, x, w1, b1, w2, b2, mask, tf32)

    x, cp, mask, label = (t(a) for a in batch(rng))

    def grads(forward):
        model.zero_grad(set_to_none=True)
        preds = forward()
        metrics.score_dict(preds, label * mask, True)["nmse"].backward()
        return preds.detach(), {k: p.grad for k, p in model.named_parameters()}

    with monkeypatch.context() as m:
        m.setattr(fno, "block_call", block)
        m.setattr(fno, "head_call", head)
        preds, got = grads(lambda: model(x, cp, mask))
    assert shapes == [("block", (B, 19, 19, 8))] * 2 + [("head", (B, H, W, 8), True)]
    want_preds, want = grads(lambda: fno2d_reference(model, x, cp, mask))
    assert (preds - want_preds).abs().max().item() <= 1e-4
    for k in want:
        assert (got[k] - want[k]).abs().max().item() <= 1e-5 * want[k].abs().max().item() + 1e-7, k


def test_block_kernel_at_the_flagship_padded_grid_in_emulation(rng):
    """73x73, the flagship's 64x64 padded by 9: odd W above 64 (pass 1's
    streamed route) and 73 rows against 8-row groups."""
    block, _ = kernel_case(rng, 1, 73, 73, 8, 12, 2, "cpu")
    check_block_with_saved(lambda *a, **k: fk._block_call(emulation(), *a, stream=0, **k), block)


def test_kernel_shapes_read_the_padded_grid_for_the_block():
    """The blocks run on the (H+p, W+p) grid, which the kernels take at any
    size: 440 columns at width 32 and 449 (440 padded by 9), whose
    inverse-columns pass runs tiled; a padded grid is checked at its padded
    size, so a refusal (a width of 0) names the padded W."""
    lib = emulation()
    fk.check_kernel_shapes(64, 440, 32, 12, 12, 128, 2, lib=lib)
    fk.check_kernel_shapes(64 + 9, 440 + 9, 32, 12, 12, 128, 2, lib=lib)
    with pytest.raises(ValueError, match="fno_block at W=449, width 0"):
        fk.check_kernel_shapes(64 + 9, 440 + 9, 0, 12, 12, 128, 2, lib=lib)


@pytest.fixture(scope="module")
def tp_padded(tmp_path_factory):
    """One Adam step of the padded FNO at ``1x2`` (its spectral weights and
    fc1 split at the rules' ``min_size`` 1024), and JAX's on one device."""
    model = worker.make_task("fno", dict(widths(3, 4), num_layers=4)).model
    case = dict(model="fno", widths=dict(widths(3, 4), num_layers=4), min_size=MIN_SIZE,
                batch=worker.global_batch(np.random.default_rng(0), 8), lr=LR,
                state=model.state_dict(), params=[n for n, _ in model.named_parameters()])
    ranks = worker.spawn(dict(kind="split_steps", mesh="1x2", cases={"fno": case}),
                         tmp_path_factory.mktemp("tp_padded"))
    return case, ranks, jax_step(case)


def test_padded_tp_step_matches_jax_and_one_process(tp_padded):
    case, ranks, want = tp_padded
    task = worker.build_task(case)
    opt, sched = make_adam(task.model.parameters(), LR, steps_per_epoch=10)
    scores = train_step(task, opt, sched, {k: t(v) for k, v in case["batch"].items()})
    for r, result in enumerate(ranks):
        got = result["fno"]
        assert got["local_params"] < got["whole_params"], r  # the model was split
        assert_step(got, want, r)
        assert math.isclose(got["scores"][0]["nmse"], float(scores["nmse"]), rel_tol=LOSS_RTOL)
        for k, p in task.model.named_parameters():
            assert (got["params"][k] - p.detach()).abs().max().item() <= PARAM_ATOL, (r, k)


def model_axis():
    return SimpleNamespace(size=2, rank=0, distributed=True)


def test_pipeline_refuses_a_padded_model():
    _, _, model = both_models(3, 4)
    with pytest.raises(NotImplementedError, match="padding 3.*pipeline.py:192"):
        PipelineStage(model, model_axis(), 2, lift=fno.lift, head=fno.head)
    task = SimpleNamespace(model=model, mesh=SimpleNamespace(model=model_axis(), size=1))
    with pytest.raises(NotImplementedError, match="padding 3"):
        split_model(task, pp_microbatches=2)


def test_spatial_sharding_refuses_a_padded_model():
    """``split_model`` with ``spatial`` takes a padded model, as XLA splits
    its padded rows: its blocks and task run on the rank's rows
    (``tests/test_torch_sp_padded.py`` holds the step to JAX's)."""
    _, _, model = both_models(2, 4)
    whole = sum(p.numel() for p in model.parameters())
    task = AutoTask(model, metrics.loss_name_to_fn("nmse"))
    task.mesh = DataMesh(model=ModelAxis(2))  # only its sizes are read
    split_model(task, spatial=True)
    axis = task.mesh.model
    assert task.rows is axis and model.sp is axis and all(b.sp is axis for b in model.blocks)
    assert task.split is not None and sum(p.numel() for p in model.parameters()) < whole


def test_padding_below_one_is_refused():
    with pytest.raises(ValueError, match="padding 0"):
        Fno2d(padding=0, generator=torch.Generator().manual_seed(0))
