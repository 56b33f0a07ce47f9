"""Spatial sharding of the latent diffusion models (``--shard_spatial 1``;
``models/vae.py`` and ``models/diffusion.py`` on a rank's rows), on gloo
ranks spawned as ``tests/_torch_dp_worker.py`` spawns them (job kind
``latent_rows``). The lite VAE (the JAX latent models always build it) and
a narrow UNet (base 8, mults (1, 2), one res block), at ``min_size`` 1024 so
that the UNet's and the CondEncoder's larger parameters are split.

- The frozen VAE's ``encode`` (mean, log-variance) of a field padded as the
  latent models pad it, and its ``decode``, at ``1x2`` on 32x32 and on 18x17
  (padded to 24x24: the last rank gains the 6 pad rows, the latents split
  (0, 1, 3)), gathered, against the port's one process and JAX's VAE: 2e-5
  of the largest value.
- One train step of v1, v2 and Lite at ``1x2`` on 32x32, of v1 and Lite at
  ``1x2`` on 18x17 and of v1 at ``2x2`` on 32x32. The posterior sample, the
  noise and the timesteps are JAX's own global draws of the step's key, put
  in the port's place. Against JAX's step, spatial
  (``batch_sharding_spatial`` on ``make_mesh("1x2")``) and on one device:
  the loss (rel 1e-5) and every gradient (1e-5 of the largest). Against
  the port's one process: the loss, the noise prediction gathered (2e-5),
  the gradients, and the parameters after Adam under
  ``test_torch_sp_pixel.py``'s gates.
- ``predict_frame`` of each model at ``1x2`` on 18x17 against one process,
  gathered, with JAX's sampler noise: ``SAMPLE_RTOL`` of the largest value.
- A ``--use_mixed_precision`` step (v1 at ``1x2`` on 32x32) against the
  port's one-process bfloat16 step within ``test_torch_sp_bf16.py``'s gates
  (loss rel 1e-3, noise prediction 3e-2 of its largest value), and off the
  float32 step by more than 1e-3 (bfloat16 ran).
- ``main_auto --model latent_diffusion_lite --mesh_shape 1x2 --shard_spatial
  1 --mode train_test`` against one process: each ``scores.json``, rel 1e-4.
- The latent grid's levels: a grid whose latents leave a rank without a
  row at some level (32x32 over 4 model ranks, 64x64 over 4 at default
  widths) is accepted, as 32x32 and 64x64 over 2 and 66x65 over 2 are
  (``tests/test_torch_sp_empty.py`` runs 32x32 over 4).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models import diffusion as jax_diffusion
from cfdbench_tpu.models import punetg as jax_punetg
from cfdbench_tpu.parallel.mesh import batch_sharding_spatial
from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.models import punetg
from cfdbench_tpu_torch.models.common import num_groups_for
from cfdbench_tpu_torch.models.diffusion import VAE_FACTOR, padded_rows
from cfdbench_tpu_torch.parallel.mesh import ModelAxis, make_mesh
from cfdbench_tpu_torch.parallel.spatial import Rows
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.training.trainer_auto import check_spatial
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from cfdbench_tpu_torch.utils.rng import EVAL_KEY, latent_keys, train_key
from tests import _torch_dp_worker as worker
from tests.test_torch_diffusion import SAMPLE_RTOL, jax_ddpm_noise, jax_key, jax_train_noise_and_t
from tests.test_torch_sp import axis_mesh
from tests.test_torch_sp_bf16 import BF16_FRAME_RTOL, BF16_LOSS_RTOL, RAN_BF16, frame_err
from tests.test_torch_sp_point import (
    FORWARD_ATOL, GRAD_RTOL, LOSS_RTOL, LR, MIN_SIZE, PARAM_ATOL, assert_scores_json_close,
    forward_err, max_rel, step_case)
from tests.test_torch_train import port_tree  # noqa: F401
from tests.test_torch_vae import jax_posterior_noise

torch.set_num_threads(1)

SMALL = dict(unet_base_channels=8, unet_channel_mult=(1, 2), unet_num_res_blocks=1,
             noise_scheduler_timesteps=20)
JAX_CLASSES = {"latent_v1": jax_diffusion.LatentDiffusionCfdModel,
               "latent": jax_diffusion.LatentDiffusionCfdModel2,
               "latent_lite": jax_diffusion.LatentDiffusionCfdModelLite}
GRIDS = {"32": (32, 32), "18": (18, 17)}
# case: (model, grid, meshes)
STEPS = {"latent_v1_32": ("latent_v1", "32", ("1x2", "2x2")),
         "latent_32": ("latent", "32", ("1x2",)),
         "latent_lite_32": ("latent_lite", "32", ("1x2",)),
         "latent_v1_18": ("latent_v1", "18", ("1x2",)),
         "latent_lite_18": ("latent_lite", "18", ("1x2",))}
KEY = train_key(0, 0)  # the key of split_step's first step
INFERENCE_STEPS = 2
VALID = 3  # step_case's batch: 4 rows, the last a weight-0 pad


def latent_shape(B, grid):
    H, W = GRIDS.get(grid, grid)
    return (B, -(-H // VAE_FACTOR), -(-W // VAE_FACTOR), 4)


def latent_case(name, grid, rng, **extra):
    """A step case whose posterior sample, noise and timesteps are JAX's
    draws for KEY over the global batch and latent grid (``grid``: a key of
    GRIDS, or (H, W))."""
    case = step_case(name, SMALL, GRIDS.get(grid, grid), rng, four_groups=True, **extra)
    shape = latent_shape(case["batch"]["labels"].shape[0], grid)
    noise_key, posterior_key = latent_keys(KEY)
    noise, t = jax_train_noise_and_t(noise_key, shape, SMALL["noise_scheduler_timesteps"], "cpu")
    case["draws"] = {"noise_and_t": {noise_key: (noise.numpy(), t.numpy())},
                     "posterior": {posterior_key: jax_posterior_noise(posterior_key, shape,
                                                                      "cpu").numpy()}}
    return case


def sample_case(name, rng):
    """An 18x17 frame case of two rows, JAX's sampler noise for the
    evaluation key over the global latent grid."""
    B, (H, W) = 2, GRIDS["18"]
    model = worker.make_task(name, SMALL).model
    shape = latent_shape(B, "18")
    draws = {(EVAL_KEY, i): jax_ddpm_noise(EVAL_KEY, i, shape, "cpu").numpy()
             for i in range(INFERENCE_STEPS + 1)}
    return dict(model=name, widths=SMALL, min_size=MIN_SIZE,
                batch=worker.global_batch(rng, B, H, W), state=model.state_dict(),
                inference_steps=INFERENCE_STEPS, draws={"sampler": draws})


def jax_vae_params():
    return params_to_flax(worker.make_task("latent", SMALL).vae.state_dict())


def jax_latent_step(name, case, mesh=None):
    """JAX's loss and gradients (the port's names) of the step's key, its
    PUNetG at four groups a GroupNorm, as the case's
    (``test_torch_diffusion.four_groups``: at base 8 a group of one channel
    cancels per-channel constants, and several gradients are rounding)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_punetg, "_num_groups", lambda groups, c: num_groups_for(4, c))
        task = JAX_CLASSES[name](jax_loss_name_to_fn("nmse"), jax_vae_params(), **SMALL)
        return _jax_step(task, case, mesh)


def _jax_step(task, case, mesh):
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    if mesh is not None:
        batch = jax.device_put(batch, batch_sharding_spatial(mesh, batch))

    def loss(p):
        return task.loss_scores(p, batch, train=True, rng=jax_key(KEY))

    (value, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params_to_flax(case["state"]))
    return dict(loss=float(value), grads=params_from_flax(jax.device_get(grads)))


@pytest.fixture(scope="module")
def latent_runs(tmp_path_factory):
    """Every rank's results of the ``1x2`` and ``2x2`` jobs, one process's,
    and JAX's steps and VAE."""
    rng = np.random.default_rng(0)
    cases = {case: latent_case(name, grid, rng) for case, (name, grid, _) in STEPS.items()}
    cases["latent_v1_32_bf16"] = dict(cases["latent_v1_32"], compute_dtype=torch.bfloat16)
    samples = {name: sample_case(name, rng) for name in JAX_CLASSES}
    vae = {grid: dict(x=rng.standard_normal((2, H, W, 2)).astype(np.float32),
                      z=rng.standard_normal(latent_shape(2, grid)).astype(np.float32))
           for grid, (H, W) in GRIDS.items()}
    job = dict(kind="latent_rows", vae=vae, cases=cases, samples=samples)
    root = tmp_path_factory.mktemp("sp_latent")
    # The ranks run while this process computes the references.
    started = {"1x2": worker.start(dict(job, mesh="1x2"), root / "1x2", world=2),
               "2x2": worker.start(dict(kind="latent_rows", mesh="2x2",
                                        cases={"latent_v1_32": cases["latent_v1_32"]}),
                                   root / "2x2", world=4)}
    jax_mesh = jax_make_mesh("1x2", tune_spectral=False)
    refs = {case: {"one device": jax_latent_step(name, cases[case]),
                   "spatial 1x2": jax_latent_step(name, cases[case], jax_mesh)}
            for case, (name, _, _) in STEPS.items()}
    ranks = {mesh: results() for mesh, results in started.items()}
    ranks["1"] = [worker.latent_rows_job(job, make_mesh("1"))]
    params = jax_vae_params()
    jax_task = JAX_CLASSES["latent"](jax_loss_name_to_fn("nmse"), params, **SMALL)
    jv = jax_task.vae
    jax_vae_out = {}
    for grid, d in vae.items():
        post = jv.apply({"params": params}, jax_task._pad_field(d["x"]), method=jv.encode)
        jax_vae_out[grid] = tuple(np.asarray(a) for a in (
            post.mean, post.logvar, jv.apply({"params": params}, d["z"], method=jv.decode)))
    return ranks, refs, jax_vae_out


@pytest.mark.parametrize("grid", list(GRIDS))
def test_sp_vae_matches_one_process_and_jax(latent_runs, grid):
    """The VAE's encode (mean, log-variance) and decode on a rank's rows,
    gathered, against one process and JAX's: 2e-5 of the largest value."""
    ranks, _, jax_vae_out = latent_runs
    wants = {"one process": ranks["1"][0]["vae"][grid], "jax": jax_vae_out[grid]}
    for r, result in enumerate(ranks["1x2"]):
        for ref, want in wants.items():
            for part, got, w in zip(("mean", "logvar", "decode"), result["vae"][grid], want):
                w = torch.as_tensor(np.asarray(w))
                assert got.shape == w.shape, (grid, ref, part, r)
                scale = w.abs().max().item()
                assert (got - w).abs().max().item() <= FORWARD_ATOL * scale, (grid, ref, part, r)


STEP_MESHES = [(case, mesh) for case, (_, _, meshes) in STEPS.items() for mesh in meshes]


@pytest.mark.parametrize("case,mesh", STEP_MESHES)
def test_sp_latent_step_matches_jax(latent_runs, case, mesh):
    """The step on ``mesh``'s ranks against JAX's spatial and one-device
    steps: the loss and every gradient."""
    ranks, refs, _ = latent_runs
    for ref, want in refs[case].items():
        for r, result in enumerate(ranks[mesh]):
            got, what = result["steps"][case], (case, mesh, ref, r)
            assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=LOSS_RTOL), what
            assert got["grads"].keys() == want["grads"].keys(), what
            assert max_rel(got["grads"], want["grads"]) <= GRAD_RTOL, what


def valid(result):
    """The noise prediction of a step's rows of weight 1: the weight-0 pad
    row's latents are the VAE's encoding of a zero field, whose GroupNorms
    normalise a constant (rounding, times 1/sqrt(eps)), and the loss reads
    none of it."""
    return dict(preds=result["preds"][:VALID])


@pytest.mark.parametrize("case,mesh", STEP_MESHES)
def test_sp_latent_step_matches_one_process(latent_runs, case, mesh):
    """The step against the port's one process: the loss, the noise
    prediction, the gradients, the parameters after Adam, alike on every
    rank."""
    ranks, _, _ = latent_runs
    want = ranks["1"][0]["steps"][case]
    gmax = max(g.abs().max().item() for g in want["grads"].values())
    for r, result in enumerate(ranks[mesh]):
        got, what = result["steps"][case], (case, mesh, r)
        assert math.isclose(got["scores"][0]["nmse"], want["scores"][0]["nmse"],
                            rel_tol=LOSS_RTOL), what
        assert got["preds"].shape == want["preds"].shape, what
        assert forward_err(valid(got), valid(want)) <= FORWARD_ATOL, what
        assert max_rel(got["grads"], want["grads"]) <= GRAD_RTOL, what
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], ranks[mesh][0]["steps"][case]["params"][k]), what
            d = (got["params"][k] - v).abs()
            big = want["grads"][k].abs() > 2 * GRAD_RTOL * gmax
            if big.any():
                assert d[big].max().item() <= PARAM_ATOL, (what, k)
            assert d.max().item() <= 2 * LR + PARAM_ATOL, (what, k)


@pytest.mark.parametrize("name", list(JAX_CLASSES))
def test_sp_latent_predict_frame_matches_one_process(latent_runs, name):
    """``predict_frame`` on an 18x17 grid at ``1x2`` (latents (0, 1, 3),
    the decode's rows (0, 8, 18) resharded to the batch's (0, 9, 18)),
    gathered, against one process, both on JAX's sampler noise."""
    ranks, _, _ = latent_runs
    want = ranks["1"][0]["frames"][name]
    assert want.shape == (2, *GRIDS["18"], 2)
    for r, result in enumerate(ranks["1x2"]):
        got = result["frames"][name]
        assert got.shape == want.shape, (name, r)
        assert (got - want).abs().max().item() <= SAMPLE_RTOL * want.abs().max().item(), (name, r)


def test_sp_latent_bf16_step_matches_one_process(latent_runs):
    """The ``--use_mixed_precision`` step of v1 at ``1x2`` against one
    process's bfloat16 step: the loss and the noise prediction within the
    bfloat16 gates, and the prediction off the float32 step's (bfloat16
    ran)."""
    ranks, _, _ = latent_runs
    one = ranks["1"][0]["steps"]
    want, float32 = one["latent_v1_32_bf16"], one["latent_v1_32"]
    preds = {k: valid(v)["preds"] for k, v in (("one", want), ("float32", float32))}
    assert frame_err(preds["one"], preds["float32"]) > RAN_BF16
    for r, result in enumerate(ranks["1x2"]):
        got = result["steps"]["latent_v1_32_bf16"]
        assert math.isclose(got["scores"][0]["nmse"], want["scores"][0]["nmse"],
                            rel_tol=BF16_LOSS_RTOL), r
        assert frame_err(valid(got)["preds"], preds["one"]) <= BF16_FRAME_RTOL, r
        assert frame_err(valid(got)["preds"], preds["float32"]) > RAN_BF16, r


# --- main_auto -----------------------------------------------------------------

def lite_argv(data_root, weights, out, mesh):
    argv = ["--model", "latent_diffusion_lite", "--ldm_vae_weights_path", str(weights),
            "--unet_base_channels", "8", "--unet_channel_mult", "1",
            "--ldm_noise_scheduler_timesteps", "10", "--ldm_num_inference_steps", "2",
            "--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root), "--num_epochs", "2",
            "--batch_size", "16", "--eval_batch_size", "16", "--eval_interval", "1",
            "--log_interval", "100", "--mode", "train_test", "--output_dir", str(out),
            "--mesh_shape", mesh]
    return argv + (["--shard_spatial", "1"] if mesh != "1" else [])


def test_main_auto_sp_latent_lite_matches_one_process(port_tree, tmp_path,  # noqa: F811
                                                      monkeypatch):
    """``main_auto --model latent_diffusion_lite --mesh_shape 1x2
    --shard_spatial 1 --mode train_test`` on the 16x16 tree (2x2 latents, a
    row a rank) against one process: each checkpoint's scores (generated
    frames) and the test's. The UNet runs at four groups a GroupNorm, as the
    steps above: with one channel a group the biases that the norms cancel
    have gradients of rounding alone, which Adam's first steps turn into
    lr·sign(g), and the runs' weights part by that."""
    weights = tmp_path / "vae"
    ckpt.save_params(worker.make_task("latent_lite", SMALL).vae.state_dict(), weights)
    monkeypatch.setattr(punetg, "num_groups_for", worker.four_groups_for)
    one = lite_argv(port_tree, weights, tmp_path / "one", "1")
    cli.main_auto(one, device="cpu")
    sp = lite_argv(port_tree, weights, tmp_path / "sp", "1x2")
    worker.spawn(dict(kind="cli", calls=[("main_auto", sp)], constants=[
        ("cfdbench_tpu_torch.models.punetg", "num_groups_for", worker.four_groups_for)]),
        tmp_path / "ranks")
    assert_scores_json_close(cli.run_dir(cli.parse_args(sp)), cli.run_dir(cli.parse_args(one)))


# --- the latent grid's levels ----------------------------------------------------

DEFAULT = dict(unet_base_channels=64, unet_channel_mult=(1, 2, 4), unet_num_res_blocks=1)


@pytest.mark.parametrize("grid,M,widths,empty", [
    ((32, 32), 4, SMALL, True), ((32, 32), 2, SMALL, False), ((64, 64), 4, DEFAULT, True),
    ((64, 64), 2, DEFAULT, False), ((66, 65), 2, DEFAULT, False)],
    ids=["32-1x4", "32-1x2", "64-1x4-default", "64-1x2-default", "66-1x2-default"])
def test_latent_rows_that_leave_a_rank_empty_are_refused(grid, M, widths, empty):
    """The latents of the padded grid through the VAE's three downsamples,
    then the UNet's levels, each on rows resharded to whole pairs: 32x32
    over 4 model ranks (a latent row a rank, none on two ranks at the UNet's
    second level) and 64x64 over 4 at default widths (8 latent rows, none
    on two ranks at the third level) leave a rank without a row, and are
    accepted all the same, as the JAX package's XLA computes them."""
    task = worker.make_task("latent_v1", widths)
    check_spatial(task.model, axis_mesh(M), grid)
    latent = task.vae.latent_rows(padded_rows(Rows.even(grid[0], ModelAxis(M))))
    levels = latent.halvings(len(widths["unet_channel_mult"]) - 1, ceil=True)
    assert any(b0 == b1 for r in levels for b0, b1 in zip(r.bounds, r.bounds[1:])) == empty
