"""The port's spatial sharding (``--shard_spatial 1``: ``parallel/spatial.py``,
the models on a rank's grid rows, ``training/trainer_auto.py``) on the CPU:
one train step of the FNO, the FFNO, the U-Net and the ResNet on gloo
ranks spawned as ``tests/_torch_dp_worker.py`` spawns them, at ``1x2``
and ``2x2``, against two references from the same weights (the port's
flax loader): JAX's own spatial step, its batch placed by
``batch_sharding_spatial`` on a ``make_mesh("1x2")`` of the conftest's
forced CPU devices, and JAX's step on one device.

- The loss (rel 1e-5), the train forward's output gathered over the rows
  and the data ranks (2e-5), and the gradient of every parameter (1e-5 of
  the largest) against both, the U-Net's running statistics after the step
  (1e-5) too. The ResNet is held to JAX with its dropout off (a rate of 0,
  and JAX's forward without dropout): torch cannot draw JAX's masks.
- The U-Net in float32 is rounding-bound: its BatchNorms normalise the
  2x2 bottleneck over 16 values a channel, so the float32 rounding of the
  batch statistics is amplified by 1/std, and the port's one-process step
  itself parts from JAX's by 1.2e-4 in its forward and 4.4e-5 of the
  largest in its gradients; in float64 the two part by 2.6e-13 and 6.2e-14
  (``tests/test_torch_unet_f64.py``), so the gap is rounding. Its split step
  is held to JAX within the larger of the gates above and twice the
  one-process step's own distance (the control), and the same step in
  float64 holds the split to one process within 1e-12.
- Against the port's one process: the step's parameters after Adam
  (1e-5; the U-Net's in float64), and the ResNet with its dropout on, its
  masks drawn over the global grid and sliced (``models/resnet.py``).
- Each rank holds its slice of the parameters that the rules split (at
  their ``min_size`` 1024, as JAX's tp tests take it).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models.ffno import Ffno2d as JaxFfno2d
from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.models.resnet import ResNet as JaxResNet
from cfdbench_tpu.models.unet import UNet as JaxUNet
from cfdbench_tpu.parallel.mesh import batch_sharding_spatial
from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu_torch.parallel.mesh import make_mesh
from cfdbench_tpu_torch.utils.flax_import import (
    batch_stats_to_flax, params_from_flax, params_to_flax)
from tests import _torch_dp_worker as worker

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
FORWARD_ATOL = 2e-5
GRAD_RTOL = 1e-5  # of the largest gradient
CONTROL_FACTOR = 2.0  # the U-Net's float32 bound over its control (see the docstring)
PARAM_ATOL = 1e-5
STATS_ATOL = 1e-5
LR = 1e-3
MIN_SIZE = 1024
# Each model's widths and its square grid: the U-Net pools four times, each
# rank keeping a row of its bottleneck at 32 rows over two ranks (other row
# counts: tests/test_torch_sp_unet.py); the ResNet's 7x7 convolutions take a
# halo of 3 rows.
MODELS = {
    "fno": (dict(num_layers=2, hidden_dim=8, modes1=4, modes2=4), 16),
    "ffno": (dict(num_layers=2, hidden_dim=8, modes1=4, modes2=4), 16),
    "unet": (dict(dim=4), 32),
    "resnet": (dict(hidden_chan=8, num_blocks=1), 16),
}
JAX_CLASSES = {"fno": JaxFno2d, "ffno": JaxFfno2d, "unet": JaxUNet, "resnet": JaxResNet}
MESHES = ("1x2", "2x2")


def sp_cases():
    rng = np.random.default_rng(0)
    cases = {}
    for name, (widths, grid) in MODELS.items():
        model = worker.make_task(name, widths).model
        # 4 rows, the last a weight-0 pad, as the pipeline pads.
        cases[name] = dict(model=name, widths=widths, min_size=MIN_SIZE, lr=LR, spatial=True,
                           batch=worker.global_batch(rng, 4, grid, grid, valid=3),
                           state=model.state_dict(), dropout=0.0,
                           params=[n for n, _ in model.named_parameters()])
    cases["resnet_dropout"] = dict(cases["resnet"], dropout=0.2)
    unet = cases["unet"]
    cases["unet_f64"] = dict(unet, dtype=torch.float64,
                             batch={k: v.astype(np.float64) for k, v in unet["batch"].items()})
    return cases


def jax_step(case, mesh=None):
    """JAX's loss, train forward, gradients and new running statistics in
    the port's layout, on one device or, with ``mesh``, the batch placed by
    ``batch_sharding_spatial``."""
    name = case["model"]
    task = JaxAutoTask(JAX_CLASSES[name](in_chan=2, out_chan=2, n_case_params=5,
                                         **case["widths"]), jax_loss_name_to_fn("nmse"))
    params = params_to_flax(case["state"])
    model_state = {"batch_stats": batch_stats_to_flax(case["state"])} if name == "unet" else {}
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    if mesh is not None:
        batch = jax.device_put(batch, batch_sharding_spatial(mesh, batch))
        assert not batch["inputs"].sharding.is_fully_replicated
    train = name != "resnet"  # the ResNet has no norm: train=False is it without dropout
    rng = jax.random.PRNGKey(0)

    def loss(p):
        preds, new_state = task._forward(p, model_state, batch, train, rng)
        labels = batch["labels"] * batch["mask"]
        scores = task.loss_fn(preds.astype(jnp.float32), labels,
                              sample_weights=batch["weights"])
        return scores["nmse"], (scores["nmse"], preds, new_state)

    grads, (value, preds, new_state) = jax.jit(jax.grad(loss, has_aux=True))(params)
    value = float(value)
    stats = jax.device_get(new_state.get("batch_stats")) if name == "unet" else None
    port = params_from_flax(jax.device_get(grads), stats)
    return dict(loss=value, preds=torch.from_numpy(np.asarray(jax.device_get(preds))),
                grads={k: port[k] for k in case["params"]},
                stats={k: v for k, v in port.items() if "running" in k})


@pytest.fixture(scope="module")
def sp_steps(tmp_path_factory):
    cases = sp_cases()
    root = tmp_path_factory.mktemp("sp_steps")
    one = make_mesh("1")
    ranks = {"1": [{name: worker.split_step(case, one) for name, case in cases.items()}]}
    for mesh in MESHES:
        ranks[mesh] = worker.spawn(dict(kind="split_steps", mesh=mesh, cases=cases), root / mesh,
                                   world=2 if mesh == "1x2" else 4)
    jax_mesh = jax_make_mesh("1x2", tune_spectral=False)
    refs = {name: {"one device": jax_step(cases[name]),
                   "spatial 1x2": jax_step(cases[name], jax_mesh)} for name in MODELS}
    return cases, ranks, refs


def forward_err(got, want) -> float:
    return (got["preds"] - want["preds"]).abs().max().item()


def max_rel(got, want) -> float:
    top = max(w.abs().max().item() for w in want.values())
    return max((got[k].double() - w.double()).abs().max().item() for k, w in want.items()) / top


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(MODELS))
def test_sp_step_matches_jax(sp_steps, name, mesh):
    """One train step on ``mesh``'s ranks, each on its block of the batch and
    its rows of the grid, against JAX's spatial step and its one-device
    step: the loss, the forward, every gradient, the U-Net's running
    statistics."""
    _, ranks, refs = sp_steps
    for ref, want in refs[name].items():
        forward_atol, grad_rtol = FORWARD_ATOL, GRAD_RTOL
        if name == "unet":
            control = ranks["1"][0][name]
            forward_atol = max(forward_atol, CONTROL_FACTOR * forward_err(control, want))
            grad_rtol = max(grad_rtol, CONTROL_FACTOR * max_rel(control["grads"], want["grads"]))
        for r, result in enumerate(ranks[mesh]):
            got, what = result[name], (name, mesh, ref, r)
            assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=LOSS_RTOL), what
            assert got["preds"].shape == want["preds"].shape, what
            assert forward_err(got, want) <= forward_atol, what
            assert got["grads"].keys() == want["grads"].keys(), what
            assert max_rel(got["grads"], want["grads"]) <= grad_rtol, what
            for k, v in want["stats"].items():
                assert (got["buffers"][k] - v).abs().max().item() <= STATS_ATOL, (what, k)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["fno", "ffno", "resnet", "resnet_dropout", "unet_f64"])
def test_sp_step_matches_one_process(sp_steps, name, mesh):
    """The same step in one process of the port: the loss, the forward, the
    gradients and the parameters after Adam (the U-Net's in float64:
    within 1e-12, its parameters 1e-10, since Adam's eps of 1e-8 turns the
    1e-16 gradients of the biases that its BatchNorms cancel into steps of
    1e-11 whose sign is rounding; the ResNet with its dropout masks too).
    Every rank holds the same parameters."""
    _, ranks, _ = sp_steps
    want = ranks["1"][0][name]
    f64 = name == "unet_f64"
    for r, result in enumerate(ranks[mesh]):
        got, what = result[name], (name, mesh, r)
        assert math.isclose(got["scores"][0]["nmse"], want["scores"][0]["nmse"],
                            rel_tol=1e-12 if f64 else LOSS_RTOL), what
        assert (got["preds"] - want["preds"]).abs().max().item() <= (
            1e-12 if f64 else FORWARD_ATOL), what
        assert max_rel(got["grads"], want["grads"]) <= (1e-12 if f64 else GRAD_RTOL), what
        for k, v in want["params"].items():
            assert (got["params"][k] - v).abs().max().item() <= (
                1e-10 if f64 else PARAM_ATOL), (what, k)
            assert torch.equal(got["params"][k], ranks[mesh][0][name]["params"][k]), (what, k)
        for k, v in want["buffers"].items():
            if v.is_floating_point():
                assert (got["buffers"][k] - v).abs().max().item() <= 1e-12, (what, k)


@pytest.mark.parametrize("name", list(MODELS))
def test_sp_ranks_hold_slices_of_the_split_parameters(sp_steps, name):
    """Under sp the parameters are split by the tp rules and gathered whole
    at use: each rank holds fewer elements than the whole model, and its
    Adam moments as many as its parameters."""
    _, ranks, _ = sp_steps
    for mesh in MESHES:
        for result in ranks[mesh]:
            got = result[name]
            assert got["local_params"] < got["whole_params"], (name, mesh)
            assert got["opt_bytes"] == 2 * 4 * got["local_params"], (name, mesh)
