"""Spatial sharding where a model level leaves a rank without a row
(``--shard_spatial 1``; ``parallel/spatial.py::Rows`` with equal bounds),
on gloo ranks spawned as ``tests/_torch_dp_worker.py`` spawns them. Such a
rank runs the level on its empty rows: it convolves nothing, adds zero sums
and a zero count to the norms, and still enters every halo, sum and gather.

- The U-Net on 16x16 at ``1x2`` (its bottleneck's one row on rank 0) and on
  32x32 at ``1x4``; ``auto_deeponet_cnn``'s CNN branch on 16x16 at ``1x2``;
  ``latent_diffusion2`` at narrow widths (``test_torch_sp_latent.SMALL``) on
  32x32 at ``1x4`` (latents of 4 rows, a row a rank; the UNet's second
  level on two of the four ranks) and on 16x16 at ``1x4`` (latents of 2
  rows: two ranks hold none of them, in the VAE's last level, the loss
  and the draws).
- One train step, from one set of weights, against JAX's spatial step
  (``batch_sharding_spatial`` on ``make_mesh("1xM")``) and its one-device
  step: the loss (rel 1e-5), the train forward gathered (2e-5), every
  gradient (1e-5 of the largest; the U-Net within its control factor, as
  ``tests/test_torch_sp_unet.py`` holds it), the U-Net's running statistics
  (1e-5). The latent model's posterior sample, noise and timesteps are
  JAX's own draws, its forward (the noise prediction) held to the port's
  one process. Each step against one process of the port; in float64
  within 1e-12, its parameters after Adam within 1e-10.
- ``Rows.pairs`` gives every split that ran before a rank could go empty
  as it gave it.
"""

import math

import numpy as np
import pytest
import torch

from cfdbench_tpu.models.point import AutoDeepONetCnn as JaxAutoDeepONetCnn
from cfdbench_tpu.models.unet import UNet as JaxUNet
from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cfdbench_tpu_torch.models.diffusion import VAE_DOWNSAMPLES, padded_rows
from cfdbench_tpu_torch.parallel.mesh import ModelAxis, make_mesh
from cfdbench_tpu_torch.parallel.spatial import Rows
from tests import _torch_dp_worker as worker
from tests.test_torch_sp_latent import SMALL, jax_latent_step, latent_case, valid
from tests.test_torch_sp_point import (
    FORWARD_ATOL, GRAD_RTOL, LOSS_RTOL, forward_err, jax_step, max_rel, step_case)
from tests.test_torch_sp_unet import CONTROL_FACTOR, STATS_ATOL, UNET, f64

torch.set_num_threads(1)

CNN = dict(field_shape=(16, 16), trunk_depth=2)
# name: (model, widths, grid, mesh)
CASES = {"unet16": ("unet", UNET, (16, 16), "1x2"),
         "unet32": ("unet", UNET, (32, 32), "1x4"),
         "cnn16": ("auto_deeponet_cnn", CNN, (16, 16), "1x2"),
         "latent32": ("latent", SMALL, (32, 32), "1x4"),
         "latent16": ("latent", SMALL, (16, 16), "1x4")}
MESHES = ("1x2", "1x4")


def jax_ref(name, case, mesh=None):
    model = CASES[name][0]
    if model == "latent":
        return jax_latent_step(model, case, mesh)
    net = (JaxUNet(in_chan=2, out_chan=2, n_case_params=5, **UNET) if model == "unet"
           else JaxAutoDeepONetCnn(in_chan=2, num_case_params=5, trunk_depth=2))
    return jax_step(case, net, mesh)


@pytest.fixture(scope="module")
def empty_steps(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases = {}
    for name, (model, widths, grid, _) in CASES.items():
        case = (latent_case(model, grid, rng) if model == "latent"
                else step_case(model, widths, grid, rng))
        cases[name], cases[name + "_f64"] = case, f64(case)
    root = tmp_path_factory.mktemp("sp_empty")
    # The ranks run while this process computes the references.
    started = {}
    for mesh in MESHES:
        job = {n: c for n, c in cases.items() if CASES[n.removesuffix("_f64")][3] == mesh}
        started[mesh] = worker.start(dict(kind="split_steps", mesh=mesh, cases=job), root / mesh,
                                     world=int(mesh[2]))
    one = make_mesh("1")
    ranks = {"1": [{n: worker.split_step(c, one) for n, c in cases.items()}]}
    jax_meshes = {mesh: jax_make_mesh(mesh, tune_spectral=False) for mesh in MESHES}
    refs = {name: {"one device": jax_ref(name, cases[name]),
                   f"spatial {mesh}": jax_ref(name, cases[name], jax_meshes[mesh])}
            for name, (_, _, _, mesh) in CASES.items()}
    ranks.update({mesh: results() for mesh, results in started.items()})
    return cases, ranks, refs


def test_a_level_leaves_a_rank_without_a_row():
    """Each case's deepest level holds no row on some rank, the splits its
    model makes (``Rows.halvings``): the U-Net's and the CNN branch's four
    poolings, the latents' VAE and UNet levels."""
    def levels(name):
        _, _, (H, _), mesh = CASES[name]
        rows = Rows.even(H, ModelAxis(int(mesh[2])))
        if name.startswith("latent"):
            latent = padded_rows(rows).halvings(VAE_DOWNSAMPLES, ceil=False)[-1]
            return latent.halvings(len(SMALL["unet_channel_mult"]) - 1, ceil=True)
        return rows.halvings(4, ceil=False)

    assert levels("unet16")[-1].bounds == (0, 1, 1)
    assert levels("unet32")[-1].bounds == (0, 1, 2, 2, 2)
    assert levels("cnn16")[-1].bounds == (0, 1, 1)
    assert levels("latent32")[0].bounds == (0, 1, 2, 3, 4)
    assert levels("latent32")[-1].bounds == (0, 1, 2, 2, 2)
    assert levels("latent16")[0].bounds == (0, 1, 2, 2, 2)


@pytest.mark.parametrize("name", list(CASES))
def test_sp_empty_step_matches_jax(empty_steps, name):
    """One train step on the case's mesh against JAX's spatial step and its
    one-device step: the loss, the forward (not the latent model's), every
    gradient, the U-Net's running statistics."""
    _, ranks, refs = empty_steps
    mesh = CASES[name][3]
    for ref, want in refs[name].items():
        forward_atol, grad_rtol = FORWARD_ATOL, GRAD_RTOL
        if name.startswith("unet"):
            control = ranks["1"][0][name]
            forward_atol = max(forward_atol, CONTROL_FACTOR * forward_err(control, want))
            grad_rtol = max(grad_rtol, CONTROL_FACTOR * max_rel(control["grads"], want["grads"]))
        for r, result in enumerate(ranks[mesh]):
            got, what = result[name], (name, mesh, ref, r)
            assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=LOSS_RTOL), what
            assert got["grads"].keys() == want["grads"].keys(), what
            assert max_rel(got["grads"], want["grads"]) <= grad_rtol, what
            if "preds" in want:
                assert got["preds"].shape == want["preds"].shape, what
                assert forward_err(got, want) <= forward_atol, what
            for k, v in want.get("stats", {}).items():
                assert (got["buffers"][k] - v).abs().max().item() <= STATS_ATOL, (what, k)


@pytest.mark.parametrize("name", list(CASES) + [n + "_f64" for n in CASES])
def test_sp_empty_step_matches_one_process(empty_steps, name):
    """The same step in one process of the port, alike on every rank: the
    loss, the forward (a latent model's on its rows of weight 1:
    ``test_torch_sp_latent.valid``), the gradients; in float64 within 1e-12,
    the parameters after Adam within 1e-10 and the running statistics within
    1e-12."""
    _, ranks, _ = empty_steps
    mesh = CASES[name.removesuffix("_f64")][3]
    want = ranks["1"][0][name]
    exact = name.endswith("_f64")
    for r, result in enumerate(ranks[mesh]):
        got, what = result[name], (name, mesh, r)
        assert math.isclose(got["scores"][0]["nmse"], want["scores"][0]["nmse"],
                            rel_tol=1e-12 if exact else LOSS_RTOL), what
        assert got["preds"].shape == want["preds"].shape, what
        assert forward_err(valid(got), valid(want)) <= (1e-12 if exact else FORWARD_ATOL), what
        assert max_rel(got["grads"], want["grads"]) <= (1e-12 if exact else GRAD_RTOL), what
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], ranks[mesh][0][name]["params"][k]), (what, k)
            if exact:
                assert (got["params"][k] - v).abs().max().item() <= 1e-10, (what, k)
        for k, v in want["buffers"].items():
            if v.is_floating_point():
                assert (got["buffers"][k] - v).abs().max().item() <= (
                    1e-12 if exact else STATS_ATOL), (what, k)


def old_pairs(bounds):
    """``Rows.pairs`` as it was while a rank could not go empty (it raised
    wherever a rank was left without a row)."""
    bounds = list(bounds)
    for j in range(1, len(bounds) - 1):
        b = bounds[j] - bounds[j] % 2
        bounds[j] = b if b > bounds[j - 1] else b + 2
    return tuple(bounds)


@pytest.mark.parametrize("M", [2, 3, 4, 8])
def test_pairs_keeps_every_split_that_ran(M):
    """Wherever the old rule gave every rank a row, the new one gives the
    same split; elsewhere it gives a split that does not fall, whose ranks
    but the last hold whole row pairs."""
    axis = ModelAxis(M)
    for H in range(1, 160):
        for rows in (Rows.even(H, axis), Rows.even(H, axis).resized(H + 3)):
            old, new = old_pairs(rows.bounds), rows.pairs()
            if all(b1 > b0 for b0, b1 in zip(old, old[1:])):
                assert new.bounds == old, (H, M, rows)
            assert new.paired() and new.H == rows.H, (H, M, rows, new)


def test_rows_refuse_falling_bounds_and_take_equal_ones():
    axis = ModelAxis(3, 2)
    rows = Rows(axis, (0, 2, 2, 2))
    assert (rows.r0, rows.h) == (2, 0)
    assert rows.halved(ceil=True).bounds == (0, 1, 1, 1)
    with pytest.raises(ValueError, match="fall"):
        Rows(axis, (0, 3, 2, 4))
