"""The port's pipeline parallelism (``parallel/pipeline.py``,
``training/trainer_auto.py::split_model`` with ``--pp_microbatches``) on
the CPU: gloo ranks spawned as ``tests/_torch_dp_worker.py`` spawns them,
against the JAX package on one device from the same weights (the port's
flax loader), at JAX's own bounds (``tests/test_parallel.py:273-377``).

- The small FNO (depth 4, width 8, 4 modes, 16x16, B=8) staged over
  ``1x2`` at 2 and 4 microbatches, over ``1x4`` at 2, and over ``2x2`` at
  2 (two data ranks of four rows, two stages each): the forward and
  the gradients within 2e-5 of JAX's, the parameters after two Adam steps
  within 3e-5 of JAX's two steps; each stage holds its own blocks and
  their moments. ``pp_pack_params``/``pp_unpack_params`` against JAX's
  ``pp_pack_params`` on the same tree, bit for bit.
- ``main_auto --mesh_shape 1x2 --pp_microbatches 2`` against one process,
  and ``--resume`` of its snapshot in one process, without pp.
- The refusals, as JAX's trainer words them: pp without a model axis, for
  a model other than the FNO, with ``--opt_state_dtype factored``.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.parallel.pipeline import pp_pack_params as jax_pp_pack_params
from cfdbench_tpu.training.optim import make_adam as jax_make_adam
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu.training.trainer_auto import TrainState, make_train_step
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.metrics import loss_name_to_fn
from cfdbench_tpu_torch.parallel import pipeline
from cfdbench_tpu_torch.parallel.mesh import DataMesh, ModelAxis
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.training import trainer_auto
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from tests import _torch_dp_worker as worker
from tests.test_torch_tp import fno_run, tp_argv
from tests.test_torch_train import port_tree, train_argv  # noqa: F401

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
FWD_ATOL = 2e-5  # forward and gradients (JAX's pp bound)
STEPS_ATOL = 3e-5  # parameters after two Adam steps
LR = 1e-3
FNO_WIDTHS = dict(num_layers=4, hidden_dim=8, modes1=4, modes2=4)
# (mesh, microbatches) of each case, as JAX's test runs them, and with a
# data axis beside the stages.
MESHES = {"1x2_k2": ("1x2", 2), "1x2_k4": ("1x2", 4), "1x4_k2": ("1x4", 2),
          "2x2_k2": ("2x2", 2)}


def jax_reference(case):
    """JAX on one device: the forward, the gradients of the first step and
    the parameters after two Adam steps."""
    task = JaxAutoTask(JaxFno2d(in_chan=2, out_chan=2, n_case_params=5, **FNO_WIDTHS),
                       jax_loss_name_to_fn("nmse"))
    params = params_to_flax(case["state"])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    grads, (scores, _) = jax.jit(jax.grad(
        lambda p: task.loss_scores(p, batch, train=True), has_aux=True))(params)
    tx = jax_make_adam(LR, steps_per_epoch=10)
    state = TrainState(params, {}, tx.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(task, tx, seed=0)
    losses = []
    for _ in range(2):
        state, s = step(state, batch)
        losses.append(float(s["nmse"]))
    preds = task.model.apply({"params": params}, batch["inputs"], batch["case_params"],
                             batch["mask"])
    return dict(preds=torch.tensor(np.asarray(preds)), losses=losses,
                grads=params_from_flax(jax.device_get(grads)),
                params=params_from_flax(jax.device_get(state.params)))


@pytest.fixture(scope="module")
def pp_steps(tmp_path_factory):
    rng = np.random.default_rng(0)
    state = worker.make_task("fno", FNO_WIDTHS).model.state_dict()
    base = dict(model="fno", widths=FNO_WIDTHS, state=state, lr=LR, steps=2,
                batch=worker.global_batch(rng, 8))
    root = tmp_path_factory.mktemp("pp_steps")
    ranks = {}
    for mesh, world in (("1x2", 2), ("1x4", 4), ("2x2", 4)):
        cases = {name: dict(base, pp=k) for name, (m, k) in MESHES.items() if m == mesh}
        for r, result in enumerate(worker.spawn(dict(kind="split_steps", mesh=mesh, cases=cases),
                                                root / mesh, world=world)):
            for name, got in result.items():
                ranks.setdefault(name, []).append(got)
    return base, ranks, jax_reference(base)


@pytest.mark.parametrize("name", list(MESHES))
def test_pp_forward_and_gradients_match_jax(pp_steps, name):
    """The first step's predictions (the last stage's, summed over the
    stages) and the gradients of every parameter, lift and head summed over
    the stages, against JAX's one-device forward and gradients."""
    _, ranks, want = pp_steps
    for got in ranks[name]:
        assert got["preds"].shape == want["preds"].shape
        assert (got["preds"] - want["preds"]).abs().max().item() <= FWD_ATOL
        assert got["grads"].keys() == want["grads"].keys()
        for k, g in want["grads"].items():
            assert (got["grads"][k] - g).abs().max().item() <= FWD_ATOL, (name, k)


@pytest.mark.parametrize("name", list(MESHES))
def test_pp_two_adam_steps_match_jax(pp_steps, name):
    """Two Adam steps: the losses (rel 1e-5) and every parameter (3e-5)
    against JAX's; each stage holds only its blocks and their moments."""
    base, ranks, want = pp_steps
    S = int(MESHES[name][0].split("x")[1])
    block = sum(v.numel() for k, v in base["state"].items() if k.startswith("blocks.0."))
    for got in ranks[name]:
        for g, w in zip(got["scores"], want["losses"]):
            assert math.isclose(g["nmse"], w, rel_tol=1e-5), (g, w)
        for k, w in want["params"].items():
            assert (got["params"][k] - w).abs().max().item() <= STEPS_ATOL, (name, k)
        others = (FNO_WIDTHS["num_layers"] - FNO_WIDTHS["num_layers"] // S) * block
        assert got["local_params"] == got["whole_params"] - others
        assert got["opt_bytes"] == 2 * 4 * got["local_params"]


@pytest.mark.parametrize("stages", [2, 4])
def test_pp_pack_matches_jax(stages):
    """The packed ``(S, L/S, ...)`` stage layout of a state dict against the
    JAX package's ``pp_pack_params`` of the same flax tree, bit for bit, and
    back."""
    state = worker.make_task("fno", FNO_WIDTHS).model.state_dict()
    packed = pipeline.pp_pack_params(state, stages, 4)
    want = jax.device_get(jax_pp_pack_params(params_to_flax(state), stages, 4))
    np.testing.assert_array_equal(packed["stages"]["weights"].numpy(),
                                  want["stages"]["SpectralConv2d_0"]["weights"])
    np.testing.assert_array_equal(packed["stages"]["w0.weight"].numpy(),
                                  np.swapaxes(want["stages"]["Dense_0"]["Dense_0"]["kernel"],
                                              -1, -2))
    np.testing.assert_array_equal(packed["stages"]["w0.bias"].numpy(),
                                  want["stages"]["Dense_0"]["Dense_0"]["bias"])
    for part, flax_part in (("lift", "lift"), ("fc1", "fc1"), ("fc2", "fc2")):
        np.testing.assert_array_equal(packed[part]["weight"].numpy(),
                                      want[flax_part]["Dense_0"]["kernel"].T)
        np.testing.assert_array_equal(packed[part]["bias"].numpy(),
                                      want[flax_part]["Dense_0"]["bias"])
    back = pipeline.pp_unpack_params(packed, 4)
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(back[k], v), k


# --- the entry point -------------------------------------------------------

@pytest.fixture(scope="module")
def pp_runs(port_tree, tmp_path_factory):  # noqa: F811
    """Two epochs in one process; two epochs on 1x2 with 2 microbatches;
    one epoch of that, then --resume in one process without pp."""
    root = tmp_path_factory.mktemp("pp_cli")
    cli.main_auto(tp_argv(port_tree, 2, root / "straight", "1"), device="cpu")
    pp = ["--pp_microbatches", "2"]
    calls = [("main_auto", tp_argv(port_tree, 2, root / "pp") + pp),
             ("main_auto", tp_argv(port_tree, 1, root / "resumed") + pp)]
    ranks = worker.spawn(dict(kind="cli", calls=calls), root / "ranks")
    cli.main_auto(tp_argv(port_tree, 2, root / "resumed", "1") + ["--resume", "1"],
                  device="cpu")
    return root, ranks


@pytest.mark.parametrize("run", ["pp", "resumed"])
def test_main_auto_pp_matches_one_process(pp_runs, run):
    """The per-step losses within rel 1e-5 of one process's and the
    checkpoints' weights within 1e-5, in the one-process layout; the weights
    every rank returns are the whole model's."""
    root, ranks = pp_runs
    got_run, want_run = fno_run(root / run), fno_run(root / "straight")
    got = json.loads((got_run / "train_losses.json").read_text())
    want = json.loads((want_run / "train_losses.json").read_text())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert math.isclose(g, w, rel_tol=LOSS_RTOL), (g, w)
    for ep in (0, 1):
        got_w = torch.load(got_run / f"ckpt-{ep}" / ckpt.MODEL_FILE, weights_only=True)
        want_w = torch.load(want_run / f"ckpt-{ep}" / ckpt.MODEL_FILE, weights_only=True)
        assert got_w.keys() == want_w.keys()
        for k in want_w:
            torch.testing.assert_close(got_w[k], want_w[k], rtol=0, atol=1e-5)
    if run == "pp":
        final = torch.load(want_run / "ckpt-1" / ckpt.MODEL_FILE, weights_only=True)
        for result in ranks:
            assert "pp: 2 stages x 2 microbatches" in result["printed"][0]
            for k, v in result["states"][0].items():
                torch.testing.assert_close(v, final[k], rtol=0, atol=1e-5)


def test_pp_refusals(port_tree, tmp_path):  # noqa: F811
    """JAX's trainer's refusals: --pp_microbatches without a model axis,
    with --opt_state_dtype factored, and for a model other than the FNO."""
    argv = train_argv(port_tree, 1) + ["--output_dir", str(tmp_path), "--mode", "train",
                                       "--pp_microbatches", "2"]
    with pytest.raises(ValueError, match="requires a mesh with a model axis > 1"):
        cli.main_auto(argv, device="cpu")
    with pytest.raises(ValueError, match="factored is not supported with pipeline"):
        cli.main_auto(argv + ["--opt_state_dtype", "factored"], device="cpu")
    task = worker.make_task("unet", dict(dim=4), loss_name_to_fn("nmse"))
    task.mesh = DataMesh(1, 0, None, ModelAxis(2, 0, None))
    with pytest.raises(ValueError, match="supports --model fno"):
        trainer_auto.split_model(task, 2)
