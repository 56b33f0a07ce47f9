"""Spatial sharding of the U-Net at row counts that do not pool evenly on a
rank, and of the ResNet with fewer rows a rank than its halo
(``--shard_spatial 1``; ``parallel/spatial.py::Rows``, ``reshard``, the deep
``halo``), on gloo ranks spawned as ``tests/_torch_dp_worker.py`` spawns them.

- The U-Net on a 66x65 grid at ``1x2`` and ``2x2`` (33 rows a rank: each
  level resharded so that every rank holds whole pooling windows) and on a
  48-row grid at ``1x2`` (24 rows a rank, not a multiple of 2^4); the
  ResNet (7x7 convolutions, a halo of 3 rows) on an 8-row grid at ``1x4``
  (2 rows a rank).
- One train step, from one set of weights (the port's flax loader), against
  JAX's spatial step (``batch_sharding_spatial`` on ``make_mesh("1x2")``)
  and JAX's one-device step: the loss (rel 1e-5), the train forward gathered
  (2e-5), every gradient (1e-5 of the largest), the U-Net's running
  statistics (1e-5). The U-Net in float32 is rounding-bound (its BatchNorms
  over the bottleneck's few values a channel; ``tests/test_torch_unet_f64.py``
  holds the port's float64 U-Net to JAX's within 1e-10): its split step is
  held to JAX within the larger of those gates and twice the port's own
  one-process step's distance to JAX (the control), and the same step in
  float64 holds the split to one process within 1e-12 (its parameters after
  Adam 1e-10). The ResNet is held to JAX with its dropout off; with it on,
  its masks drawn over the global grid and sliced, to one process.
"""

import math

import numpy as np
import pytest
import torch

from cfdbench_tpu.models.resnet import ResNet as JaxResNet
from cfdbench_tpu.models.unet import UNet as JaxUNet
from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tests.test_torch_sp_point import (
    FORWARD_ATOL, GRAD_RTOL, LOSS_RTOL, PARAM_ATOL, forward_err, jax_step, max_rel,
    spawn_meshes, step_case)

torch.set_num_threads(1)

CONTROL_FACTOR = 2.0  # the U-Net's float32 bound over its control
STATS_ATOL = 1e-5
UNET = dict(dim=4)
RESNET = dict(hidden_chan=8, num_blocks=1)
# name: (model, widths, grid (H, W), meshes)
CASES = {
    "unet66": ("unet", UNET, (66, 65), ("1x2", "2x2")),
    "unet48": ("unet", UNET, (48, 20), ("1x2",)),
    "resnet8": ("resnet", RESNET, (8, 12), ("1x4",)),
}
JAX_CLASSES = {"unet": JaxUNet, "resnet": JaxResNet}


def f64(case):
    return dict(case, dtype=torch.float64,
                batch={k: v.astype(np.float64) for k, v in case["batch"].items()})


@pytest.fixture(scope="module")
def rows_steps(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("sp_rows")
    cases, ranks, refs = {}, {}, {}
    jax_mesh = jax_make_mesh("1x2", tune_spectral=False)
    for name, (model, widths, (H, W), meshes) in CASES.items():
        case = step_case(model, widths, (H, W), rng, dropout=0.0)
        extra = ({"_f64": f64(case)} if model == "unet"
                 else {"_dropout": dict(case, dropout=0.2)})
        group = {name: case, **{name + k: v for k, v in extra.items()}}
        cases.update(group)
        got = spawn_meshes(group, root / name, meshes)
        for mesh, result in got.items():
            ranks.setdefault(mesh, [{} for _ in result])
            for r, res in enumerate(result):
                ranks[mesh][r].update(res)
        jax_model = JAX_CLASSES[model](in_chan=2, out_chan=2, n_case_params=5, **widths)
        train = model != "resnet"  # the ResNet has no norm: train=False is it without dropout
        refs[name] = {"one device": jax_step(case, jax_model, train=train),
                      "spatial 1x2": jax_step(case, jax_model, jax_mesh, train=train)}
    return cases, ranks, refs


STEPS = [(name, mesh) for name, (_, _, _, meshes) in CASES.items() for mesh in meshes]


@pytest.mark.parametrize("name,mesh", STEPS)
def test_sp_rows_step_matches_jax(rows_steps, name, mesh):
    """One train step on ``mesh``'s ranks against JAX's spatial step and its
    one-device step: the loss, the forward, every gradient, the U-Net's
    running statistics."""
    _, ranks, refs = rows_steps
    for ref, want in refs[name].items():
        forward_atol, grad_rtol = FORWARD_ATOL, GRAD_RTOL
        if name.startswith("unet"):
            control = ranks["1"][0][name]
            forward_atol = max(forward_atol, CONTROL_FACTOR * forward_err(control, want))
            grad_rtol = max(grad_rtol, CONTROL_FACTOR * max_rel(control["grads"], want["grads"]))
        for r, result in enumerate(ranks[mesh]):
            got, what = result[name], (name, mesh, ref, r)
            assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=LOSS_RTOL), what
            assert got["preds"].shape == want["preds"].shape, what
            assert forward_err(got, want) <= forward_atol, what
            assert max_rel(got["grads"], want["grads"]) <= grad_rtol, what
            for k, v in want["stats"].items():
                assert (got["buffers"][k] - v).abs().max().item() <= STATS_ATOL, (what, k)


@pytest.mark.parametrize("name,mesh", [(n + "_f64", m) for n, m in STEPS if n.startswith("unet")]
                         + [("resnet8", "1x4"), ("resnet8_dropout", "1x4")])
def test_sp_rows_step_matches_one_process(rows_steps, name, mesh):
    """The same step in one process of the port: the loss, the forward, the
    gradients and the parameters after Adam, alike on every rank (the U-Net
    in float64: within 1e-12, its parameters 1e-10, since Adam's eps of 1e-8
    turns the 1e-16 gradients of the biases that its BatchNorms cancel into
    steps whose sign is rounding); the running statistics."""
    _, ranks, _ = rows_steps
    want = ranks["1"][0][name]
    exact = name.endswith("_f64")
    for r, result in enumerate(ranks[mesh]):
        got, what = result[name], (name, mesh, r)
        assert math.isclose(got["scores"][0]["nmse"], want["scores"][0]["nmse"],
                            rel_tol=1e-12 if exact else LOSS_RTOL), what
        assert forward_err(got, want) <= (1e-12 if exact else FORWARD_ATOL), what
        assert max_rel(got["grads"], want["grads"]) <= (1e-12 if exact else GRAD_RTOL), what
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], ranks[mesh][0][name]["params"][k]), (what, k)
            assert (got["params"][k] - v).abs().max().item() <= (
                1e-10 if exact else PARAM_ATOL), (what, k)
        for k, v in want["buffers"].items():
            if v.is_floating_point():
                assert (got["buffers"][k] - v).abs().max().item() <= (
                    1e-12 if exact else STATS_ATOL), (what, k)
