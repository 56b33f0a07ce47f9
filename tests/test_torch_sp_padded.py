"""Spatial sharding of the padded FNO (``Fno2d(padding=p)`` with
``--shard_spatial 1``; ``models/fno.py::padded_rows``), on gloo ranks
spawned as ``tests/_torch_dp_worker.py`` spawns them.

Every rank pads its ``p`` columns and the last rank its ``p`` rows, so the
padded grid splits unevenly (16 rows padded by 3 at ``1x2``: 8 and 11 of
19); every block runs on that split, and the crop drops the pad again
before the head.

- One train step (depth 2, width 8, 4 modes; ``padding`` 3, and 9, more
  than a rank's 8 rows) on 16x16 at ``1x2`` and ``2x2``, from one set of
  weights, against JAX's spatial step (``batch_sharding_spatial`` on
  ``make_mesh("1x2")``) and its one-device step: the loss (rel 1e-5), the
  train forward gathered (2e-5), every gradient (1e-5 of the largest).
  Against the port's one process: the same gates, and in float64 within
  1e-12, the parameters after Adam within 1e-10.
- The padded grid's split, pad and crop on each rank. (The block kernel's
  two halves on such rows, through its CPU emulation and on the card, are
  in ``tests/test_torch_kernels.py``, which imports no JAX.)
"""

import math

import numpy as np
import pytest
import torch

from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cfdbench_tpu_torch.models.fno import crop, pad, padded_rows
from cfdbench_tpu_torch.parallel.mesh import ModelAxis
from tests.test_torch_sp_point import (
    FORWARD_ATOL, GRAD_RTOL, LOSS_RTOL, forward_err, jax_step, max_rel, spawn_meshes, step_case)
from tests.test_torch_sp_unet import f64

torch.set_num_threads(1)

GRID = (16, 16)
MESHES = ("1x2", "2x2")
PADDINGS = (3, 9)


def widths(padding):
    return dict(num_layers=2, hidden_dim=8, modes1=4, modes2=4, padding=padding)


@pytest.fixture(scope="module")
def padded_steps(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases = {}
    for p in PADDINGS:
        case = step_case("fno", widths(p), GRID, rng)
        cases[f"p{p}"], cases[f"p{p}_f64"] = case, f64(case)
    ranks = spawn_meshes(cases, tmp_path_factory.mktemp("sp_padded"), MESHES)
    jax_mesh = jax_make_mesh("1x2", tune_spectral=False)
    refs = {}
    for p in PADDINGS:
        model = JaxFno2d(in_chan=2, out_chan=2, n_case_params=5, **widths(p))
        refs[f"p{p}"] = {"one device": jax_step(cases[f"p{p}"], model),
                         "spatial 1x2": jax_step(cases[f"p{p}"], model, jax_mesh)}
    return cases, ranks, refs


STEPS = [(f"p{p}", mesh) for p in PADDINGS for mesh in MESHES]


@pytest.mark.parametrize("name,mesh", STEPS)
def test_sp_padded_step_matches_jax(padded_steps, name, mesh):
    """One train step on ``mesh``'s ranks against JAX's spatial step and its
    one-device step: the loss, the forward, every gradient."""
    _, ranks, refs = padded_steps
    for ref, want in refs[name].items():
        for r, result in enumerate(ranks[mesh]):
            got, what = result[name], (name, mesh, ref, r)
            assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=LOSS_RTOL), what
            assert got["preds"].shape == want["preds"].shape, what
            assert forward_err(got, want) <= FORWARD_ATOL, what
            assert got["grads"].keys() == want["grads"].keys(), what
            assert max_rel(got["grads"], want["grads"]) <= GRAD_RTOL, what


@pytest.mark.parametrize("name,mesh", STEPS + [(n + "_f64", m) for n, m in STEPS])
def test_sp_padded_step_matches_one_process(padded_steps, name, mesh):
    """The same step in one process of the port: the loss, the forward and
    the gradients, alike on every rank, each rank holding a slice of the
    split parameters; in float64 within 1e-12, and the parameters after
    Adam within 1e-10."""
    _, ranks, _ = padded_steps
    want = ranks["1"][0][name]
    exact = name.endswith("_f64")
    for r, result in enumerate(ranks[mesh]):
        got, what = result[name], (name, mesh, r)
        assert got["local_params"] < got["whole_params"], what
        assert math.isclose(got["scores"][0]["nmse"], want["scores"][0]["nmse"],
                            rel_tol=1e-12 if exact else LOSS_RTOL), what
        assert forward_err(got, want) <= (1e-12 if exact else FORWARD_ATOL), what
        assert max_rel(got["grads"], want["grads"]) <= (1e-12 if exact else GRAD_RTOL), what
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], ranks[mesh][0][name]["params"][k]), (what, k)
            if exact:
                assert (got["params"][k] - v).abs().max().item() <= 1e-10, (what, k)


@pytest.mark.parametrize("H,p,M,bounds", [
    (64, 9, 2, (0, 32, 73)), (66, 9, 2, (0, 33, 75)), (16, 3, 2, (0, 8, 19)),
    (16, 9, 4, (0, 4, 8, 12, 25))])
def test_padded_split_gives_the_last_rank_the_pad(H, p, M, bounds):
    """The padded grid's split: the even split of the data's rows, the last
    rank's grown by the pad (the flagship's 64 rows padded by 9 at ``1x2``:
    32 and 41 of 73); every rank pads its columns and the last its rows, and
    the crop gives back each rank's rows."""
    for rank in range(M):
        rows = padded_rows(H // M, p, ModelAxis(M, rank))
        assert rows.bounds == bounds
        x = torch.randn((2, H // M, 5, 3))
        y = pad(x, p, rows)
        assert y.shape == (2, rows.h, 5 + p, 3)
        assert torch.equal(crop(y, p, H // M), x)
        assert not y[:, H // M:].any() and not y[:, :, 5:].any()
    unpadded = ModelAxis(M)
    assert padded_rows(H // M, None, unpadded) is unpadded  # the even split
