"""Spatial sharding of pixel diffusion (``--shard_spatial 1``;
``models/punetg.py`` and ``models/diffusion.py`` on a rank's rows), on gloo
ranks spawned as ``tests/_torch_dp_worker.py`` spawns them.

- One train step of a narrow PUNetG (base 8, mults (1, 2), one res block,
  dropout 0.1) on a 16x16 grid at ``1x2`` and ``2x2`` and on a 66x65 grid
  at ``1x2`` (33 rows a rank: the stride-2 ``down`` reads rows resharded to
  whole pairs, the decoder's repeat is resharded to the skip's rows). The
  noise, the timesteps and the dropout masks are JAX's own global draws of
  the step's key, put in the port's place (``_torch_dp_worker.fixed_draws``),
  so JAX and the port see the same draws; each rank takes its rows. Against
  JAX's step, spatial (``batch_sharding_spatial`` on ``make_mesh("1x2")``)
  and on one device: the loss (rel 1e-5) and every gradient (1e-5 of the
  largest). Against the port's one process: the loss, the noise prediction
  gathered (2e-5), the gradients, and the parameters after Adam (1e-5 where
  a gradient is above twice its bound, else within 2 lr: Adam's first step
  is lr·sign(g) there, and the gradients of the biases that a GroupNorm of
  one channel a group cancels are rounding).
- ``main_auto --model pixel_diffusion --mesh_shape 1x2 --shard_spatial 1
  --mode train_test`` against one process: each checkpoint's
  ``scores.json`` and the test's (generated frames, their sampler's noise
  drawn over the global grid and sliced), rel 1e-4.
"""

import math

import jax
import numpy as np
import pytest
import torch

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models import diffusion as jax_diffusion
from cfdbench_tpu.parallel.mesh import batch_sharding_spatial
from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from cfdbench_tpu_torch.utils.rng import train_key
from tests import _torch_dp_worker as worker
from tests.test_torch_diffusion import jax_dropout_masks, jax_key, jax_train_noise_and_t
from tests.test_torch_sp_point import (
    FORWARD_ATOL, GRAD_RTOL, LOSS_RTOL, LR, PARAM_ATOL, assert_scores_json_close, forward_err,
    max_rel, spawn_meshes, step_case)
from tests.test_torch_train import port_tree  # noqa: F401

torch.set_num_threads(1)

PIXEL = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1, dropout=0.1,
             noise_scheduler_timesteps=20)
# name: (grid, meshes)
GRIDS = {"pixel16": ((16, 16), ("1x2", "2x2")), "pixel66": ((66, 65), ("1x2",))}
KEY = train_key(0, 0)  # the key of split_step's first step


def jax_task():
    return jax_diffusion.PixelDiffusionCfdModel(jax_loss_name_to_fn("nmse"), 2, 5, 16, **PIXEL)


def pixel_case(grid, rng):
    """A step case whose draws are JAX's for KEY over the global batch."""
    case = step_case("pixel", PIXEL, grid, rng)
    shape = case["batch"]["labels"].shape
    noise, t = jax_train_noise_and_t(KEY, shape, PIXEL["noise_scheduler_timesteps"], "cpu")
    unet = worker.make_task("pixel", PIXEL).model
    masks = jax_dropout_masks(jax_task().unet)(KEY, unet.dropout_shapes(shape),
                                               PIXEL["dropout"], "cpu")
    case["draws"] = {"noise_and_t": {KEY: (noise.numpy(), t.numpy())},
                     "masks": {KEY: [m.numpy() for m in masks]}}
    return case


def jax_pixel_step(case, mesh=None):
    """JAX's loss and gradients (the port's names) of the step's key."""
    task = jax_task()
    batch = case["batch"]
    if mesh is not None:
        batch = jax.device_put(batch, batch_sharding_spatial(mesh, batch))

    def loss(p):
        return task.loss_scores(p, batch, train=True, rng=jax_key(KEY))

    (value, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params_to_flax(case["state"]))
    return dict(loss=float(value), grads=params_from_flax(jax.device_get(grads)))


@pytest.fixture(scope="module")
def pixel_steps(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("sp_pixel")
    jax_mesh = jax_make_mesh("1x2", tune_spectral=False)
    ranks, refs = {}, {}
    for name, (grid, meshes) in GRIDS.items():
        case = pixel_case(grid, rng)
        ranks[name] = spawn_meshes({name: case}, root / name, meshes)
        refs[name] = {"one device": jax_pixel_step(case),
                      "spatial 1x2": jax_pixel_step(case, jax_mesh)}
    return ranks, refs


STEPS = [(name, mesh) for name, (_, meshes) in GRIDS.items() for mesh in meshes]


@pytest.mark.parametrize("name,mesh", STEPS)
def test_sp_pixel_step_matches_jax(pixel_steps, name, mesh):
    """The step on ``mesh``'s ranks against JAX's spatial and one-device
    steps: the loss and every gradient."""
    ranks, refs = pixel_steps
    for ref, want in refs[name].items():
        for r, result in enumerate(ranks[name][mesh]):
            got, what = result[name], (name, mesh, ref, r)
            assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=LOSS_RTOL), what
            assert got["grads"].keys() == want["grads"].keys(), what
            assert max_rel(got["grads"], want["grads"]) <= GRAD_RTOL, what


@pytest.mark.parametrize("name,mesh", STEPS)
def test_sp_pixel_step_matches_one_process(pixel_steps, name, mesh):
    """The step against the port's one process: the loss, the noise
    prediction, the gradients, the parameters after Adam, alike on every
    rank."""
    ranks, _ = pixel_steps
    want = ranks[name]["1"][0][name]
    gmax = max(g.abs().max().item() for g in want["grads"].values())
    for r, result in enumerate(ranks[name][mesh]):
        got, what = result[name], (name, mesh, r)
        assert math.isclose(got["scores"][0]["nmse"], want["scores"][0]["nmse"],
                            rel_tol=LOSS_RTOL), what
        assert got["preds"].shape == want["preds"].shape, what
        assert forward_err(got, want) <= FORWARD_ATOL, what
        assert max_rel(got["grads"], want["grads"]) <= GRAD_RTOL, what
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], ranks[name][mesh][0][name]["params"][k]), what
            d = (got["params"][k] - v).abs()
            big = want["grads"][k].abs() > 2 * GRAD_RTOL * gmax
            if big.any():
                assert d[big].max().item() <= PARAM_ATOL, (what, k)
            assert d.max().item() <= 2 * LR + PARAM_ATOL, (what, k)


# --- main_auto -----------------------------------------------------------------

PIXEL_FLAGS = ["--model", "pixel_diffusion", "--pixel_diffusion_base_channels", "8",
               "--pixel_diffusion_channel_mults", "1", "2", "--pixel_diffusion_num_res_blocks",
               "1", "--ldm_noise_scheduler_timesteps", "10", "--ldm_num_inference_steps", "2"]


def pixel_argv(data_root, out, mesh):
    argv = PIXEL_FLAGS + [
        "--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root), "--num_epochs", "2",
        "--batch_size", "16", "--eval_batch_size", "16", "--eval_interval", "1",
        "--log_interval", "100", "--mode", "train_test", "--output_dir", str(out),
        "--mesh_shape", mesh]
    return argv + (["--shard_spatial", "1"] if mesh != "1" else [])


def test_main_auto_sp_pixel_diffusion_matches_one_process(port_tree, tmp_path):  # noqa: F811
    """``main_auto --model pixel_diffusion --mesh_shape 1x2 --shard_spatial 1
    --mode train_test`` against one process: each checkpoint's scores
    (its dev scores of generated frames) and the test's."""
    one = pixel_argv(port_tree, tmp_path / "one", "1")
    cli.main_auto(one, device="cpu")
    sp = pixel_argv(port_tree, tmp_path / "sp", "1x2")
    worker.spawn(dict(kind="cli", calls=[("main_auto", sp)]), tmp_path / "ranks")
    assert_scores_json_close(cli.run_dir(cli.parse_args(sp)), cli.run_dir(cli.parse_args(one)))
