"""Spatial sharding of the four point models (``--shard_spatial 1``;
``models/point.py`` on a rank's rows) on the CPU, on gloo ranks spawned as
``tests/_torch_dp_worker.py`` spawns them, at ``1x2`` and ``2x2``.

- One train step of ``AutoFfn``, ``AutoDeepONet`` and ``AutoEDeepONet`` on
  a 16x16 grid and of ``AutoDeepONetCnn`` on a 32x32 grid (its four
  poolings leave every rank a row), from one set of weights (the port's
  flax loader), against JAX's spatial step (its batch placed by
  ``batch_sharding_spatial`` on ``make_mesh("1x2")`` of the conftest's CPU
  devices), JAX's step on one device, and the port's one process: the loss
  (rel 1e-5), the train forward gathered over the rows and the data ranks
  (2e-5), every gradient (1e-5 of the largest) and, against the port's one
  process, the parameters after Adam (1e-5). Each rank holds its slice of
  the parameters that the rules split (at ``min_size`` 1024).
- ``main_auto --mesh_shape 1x2 --shard_spatial 1 --mode train_test`` for
  ``auto_deeponet`` against one process: each checkpoint's ``scores.json``
  and the test scores (rel 1e-4).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.config import Args as JaxArgs
from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models import init_auto_model as jax_init_auto_model
from cfdbench_tpu.models.point import AutoDeepONetCnn as JaxAutoDeepONetCnn
from cfdbench_tpu.parallel.mesh import batch_sharding_spatial
from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.parallel.mesh import make_mesh
from cfdbench_tpu_torch.utils.flax_import import (
    batch_stats_to_flax, params_from_flax, params_to_flax)
from tests import _torch_dp_worker as worker
from tests.test_torch_train import port_tree  # noqa: F401

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
FORWARD_ATOL = 2e-5
GRAD_RTOL = 1e-5  # of the largest gradient
PARAM_ATOL = 1e-5
SCORE_RTOL = 1e-4
LR = 1e-3
MIN_SIZE = 1024
MESHES = ("1x2", "2x2")
# Each model's JAX flags, the port's constructor arguments at them, and its
# square grid.
MODELS = {
    "auto_ffn": (["--autoffn_width", "16", "--autoffn_depth", "2"],
                 dict(input_field_dim=256, num_case_params=5, width=16, depth=2), 16),
    "auto_deeponet": (["--deeponet_width", "16", "--branch_depth", "2", "--trunk_depth", "2"],
                      dict(branch_dim=261, width=16, branch_depth=2, trunk_depth=2), 16),
    "auto_edeeponet": (["--autoedeeponet_width", "16", "--autoedeeponet_depth", "2"],
                       dict(dim_branch1=256, dim_branch2=5, width=16, branch_depth=2,
                            trunk_depth=2), 16),
    "auto_deeponet_cnn": ([], dict(field_shape=(32, 32), trunk_depth=2), 32),
}


def jax_model(name, grid):
    if name == "auto_deeponet_cnn":
        return JaxAutoDeepONetCnn(in_chan=2, num_case_params=5, trunk_depth=2)
    return jax_init_auto_model(JaxArgs.parse_args(["--model", name] + MODELS[name][0]),
                               n_case_params=5, field_shape=(grid, grid))


def step_case(name, widths, grid, rng, **extra):
    """A split_steps case of ``name`` on a ``grid`` (H, W) or square grid:
    4 rows, the last a weight-0 pad, as the pipeline pads."""
    H, W = (grid, grid) if isinstance(grid, int) else grid
    model = worker.make_task(name, widths).model
    return dict(model=name, widths=widths, min_size=MIN_SIZE, lr=LR, spatial=True,
                batch=worker.global_batch(rng, 4, H, W, valid=3), state=model.state_dict(),
                params=[n for n, _ in model.named_parameters()], **extra)


def jax_step(case, model, mesh=None, train=True, compute_dtype=None):
    """JAX's loss, train forward, gradients and new running statistics in
    the port's layout, on one device or, with ``mesh``, the batch placed by
    ``batch_sharding_spatial``; a point model's loss against the flat u."""
    task = JaxAutoTask(model, jax_loss_name_to_fn("nmse"), compute_dtype=compute_dtype)
    params = params_to_flax(case["state"])
    stats = batch_stats_to_flax(case["state"])
    model_state = {"batch_stats": stats} if stats else {}
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    if mesh is not None:
        batch = jax.device_put(batch, batch_sharding_spatial(mesh, batch))
        assert not batch["inputs"].sharding.is_fully_replicated

    def loss(p):
        preds, new_state = task._forward(p, model_state, batch, train, jax.random.PRNGKey(0))
        B = batch["labels"].shape[0]
        labels = (batch["labels"][..., 0].reshape(B, -1) if task.pointwise
                  else batch["labels"] * batch["mask"])
        scores = task.loss_fn(preds.astype(jnp.float32), labels,
                              sample_weights=batch["weights"])
        return scores["nmse"], (scores["nmse"], preds, new_state)

    grads, (value, preds, new_state) = jax.jit(jax.grad(loss, has_aux=True))(params)
    new_stats = jax.device_get(new_state.get("batch_stats")) if stats else None
    port = params_from_flax(jax.device_get(grads), new_stats)
    return dict(loss=float(value),
                preds=torch.from_numpy(np.asarray(jax.device_get(preds), np.float32)),
                grads={k: port[k] for k in case["params"]},
                stats={k: v for k, v in port.items() if "running" in k})


def forward_err(got, want) -> float:
    return (got["preds"].float() - want["preds"].float()).abs().max().item()


def max_rel(got, want) -> float:
    top = max(w.abs().max().item() for w in want.values())
    return max((got[k].double() - w.double()).abs().max().item() for k, w in want.items()) / top


def spawn_meshes(cases, root, meshes=MESHES):
    """Each mesh's ranks' split_steps of ``cases``, and one process's."""
    one = make_mesh("1")
    ranks = {"1": [{name: worker.split_step(case, one) for name, case in cases.items()}]}
    for mesh in meshes:
        d, m = (int(s) for s in mesh.split("x"))
        ranks[mesh] = worker.spawn(dict(kind="split_steps", mesh=mesh, cases=cases), root / mesh,
                                   world=d * m)
    return ranks


@pytest.fixture(scope="module")
def point_steps(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases = {name: step_case(name, widths, grid, rng)
             for name, (_, widths, grid) in MODELS.items()}
    ranks = spawn_meshes(cases, tmp_path_factory.mktemp("sp_point"))
    jax_mesh = jax_make_mesh("1x2", tune_spectral=False)
    refs = {}
    for name, case in cases.items():
        model = jax_model(name, MODELS[name][2])
        refs[name] = {"one device": jax_step(case, model),
                      "spatial 1x2": jax_step(case, model, jax_mesh)}
    return cases, ranks, refs


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(MODELS))
def test_sp_point_step_matches_jax(point_steps, name, mesh):
    """One train step on ``mesh``'s ranks, each on its block of the batch and
    its query rows, against JAX's spatial step and its one-device step:
    the loss, the forward, every gradient."""
    _, ranks, refs = point_steps
    for ref, want in refs[name].items():
        for r, result in enumerate(ranks[mesh]):
            got, what = result[name], (name, mesh, ref, r)
            assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=LOSS_RTOL), what
            assert got["preds"].shape == want["preds"].shape, what
            assert forward_err(got, want) <= FORWARD_ATOL, what
            assert got["grads"].keys() == want["grads"].keys(), what
            assert max_rel(got["grads"], want["grads"]) <= GRAD_RTOL, what


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(MODELS))
def test_sp_point_step_matches_one_process(point_steps, name, mesh):
    """The same step in one process of the port: the loss, the forward, the
    gradients and the parameters after Adam, alike on every rank; each rank
    holds a slice of the split parameters."""
    _, ranks, _ = point_steps
    want = ranks["1"][0][name]
    for r, result in enumerate(ranks[mesh]):
        got, what = result[name], (name, mesh, r)
        assert math.isclose(got["scores"][0]["nmse"], want["scores"][0]["nmse"],
                            rel_tol=LOSS_RTOL), what
        assert forward_err(got, want) <= FORWARD_ATOL, what
        assert max_rel(got["grads"], want["grads"]) <= GRAD_RTOL, what
        for k, v in want["params"].items():
            assert (got["params"][k] - v).abs().max().item() <= PARAM_ATOL, (what, k)
            assert torch.equal(got["params"][k], ranks[mesh][0][name]["params"][k]), (what, k)
        assert got["local_params"] < got["whole_params"], what


# --- main_auto -----------------------------------------------------------------

POINT_FLAGS = ["--model", "auto_deeponet", "--deeponet_width", "16", "--branch_depth", "2",
               "--trunk_depth", "2"]


def point_argv(data_root, out, mesh):
    argv = POINT_FLAGS + [
        "--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root), "--num_epochs", "2",
        "--batch_size", "16", "--eval_batch_size", "16", "--eval_interval", "1",
        "--log_interval", "100", "--mode", "train_test", "--output_dir", str(out),
        "--mesh_shape", mesh]
    return argv + (["--shard_spatial", "1"] if mesh != "1" else [])


def assert_scores_json_close(got_run, want_run):
    """Each checkpoint's and the test's ``scores.json``, rel SCORE_RTOL (not
    the epoch's seconds)."""
    files = sorted(p.relative_to(want_run) for p in want_run.rglob("scores.json"))
    assert files and files == sorted(p.relative_to(got_run) for p in got_run.rglob("scores.json"))
    for f in files:
        got, want = (json.loads((r / f).read_text()) for r in (got_run, want_run))
        for k, w in numbers(want).items():
            if k == "/time":  # the epoch's seconds
                continue
            g = numbers(got)[k]
            assert math.isclose(g, w, rel_tol=SCORE_RTOL, abs_tol=1e-9), (f, k, g, w)


def numbers(obj, prefix=""):
    """Every number of a JSON tree, by its path."""
    if isinstance(obj, dict):
        return {k2: v2 for k, v in obj.items()
                for k2, v2 in numbers(v, f"{prefix}/{k}").items()}
    if isinstance(obj, list):
        return {k2: v2 for i, v in enumerate(obj)
                for k2, v2 in numbers(v, f"{prefix}/{i}").items()}
    return {prefix: float(obj)} if isinstance(obj, (int, float)) else {}


def test_main_auto_sp_point_model_matches_one_process(port_tree, tmp_path):  # noqa: F811
    """``main_auto --model auto_deeponet --mesh_shape 1x2 --shard_spatial 1
    --mode train_test`` against one process: each checkpoint's scores and
    the test's."""
    one = point_argv(port_tree, tmp_path / "one", "1")
    cli.main_auto(one, device="cpu")
    sp = point_argv(port_tree, tmp_path / "sp", "1x2")
    worker.spawn(dict(kind="cli", calls=[("main_auto", sp)]), tmp_path / "ranks")
    assert_scores_json_close(cli.run_dir(cli.parse_args(sp)), cli.run_dir(cli.parse_args(one)))
