"""The other trainers' entry points on a model axis on the CPU: two gloo
ranks at ``--mesh_shape 1x2`` (``tests/_torch_dp_worker.py``, job kind
``cli``), against the port's one process on the same flags, rel 1e-4, the
sharding rules' threshold lowered to MIN_SIZE in the ranks so that the
narrow test networks split.

- ``main_train --mode train_test`` (the DeepONet) on a replicated model
  axis: per-step losses, dev and test scores, predictions; both ranks'
  weights alike.
- ``main_gencast --mode train_test`` with ``--gradient_accumulation_steps
  2`` and ``--use_gradient_checkpointing 1`` (the recompute re-runs the
  gather hooks on both ranks): dev and test scores, the generated frames,
  ``best_model/`` in the one-process layout; GenCast's ``main_multistep``
  on the model axis against one process's rollout of the same checkpoint;
  resume across meshes (one epoch on 1x2 then the second in one process,
  and the other way), the accumulator set at the epoch's end, against two
  epochs in one process.
- ``main_uncond`` (its EMA sampled on both ranks each epoch, rank 0's plot
  written once) resumed across meshes against two epochs in one process:
  the per-step losses, ``ema_model/`` and ``training_state/`` in the
  one-process layout.
"""

import json
import math

import numpy as np
import pytest
import torch

from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.training import trainer_gencast, trainer_uncond
from tests import _torch_dp_worker as worker
from tests.test_torch_generative_cli import gen_argv
from tests.test_torch_nonauto_cli import nonauto_run
from tests.test_torch_parallel_trainers import train_argv as deeponet_argv
from tests.test_torch_parallel_trainers import uncond_argv
from tests.test_torch_train import port_tree, result_files  # noqa: F401  (port_tree: a fixture)

torch.set_num_threads(1)

RTOL = 1e-4  # two ranks against one process through an entry point
MIN_SIZE = 256  # the sharding rules' threshold in the ranks
MESH = ["--mesh_shape", "1x2"]
CONSTANTS = [("cfdbench_tpu_torch.parallel.sharding_rules", "MIN_SIZE", MIN_SIZE),
             ("cfdbench_tpu_torch.training.trainer_uncond", "SAMPLE_EVERY", 1)]


def gencast_argv(data_root, out, epochs, mode="train_test"):
    return gen_argv("gencast", data_root, epochs, out)[:-2] + [
        "--gradient_accumulation_steps", "2", "--use_gradient_checkpointing", "1",
        "--batch_size", "12", "--mode", mode]


def gencast_run(out):
    return cli.run_dir(Args.parse_args(gencast_argv("", out, 1)))


def uncond_run(out):
    return out / "uncond_ddpm" / "cavity_prop_bc_geo"


def load(run, name):
    return json.loads((run / name).read_text())


def numbers(obj):
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in numbers(obj[k])]
    if isinstance(obj, list):
        return [x for v in obj for x in numbers(v)]
    return [obj]


def assert_files_close(got_run, want_run, names):
    for name in names:
        got, want = numbers(load(got_run, name)), numbers(load(want_run, name))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert math.isclose(g, w, rel_tol=RTOL, abs_tol=1e-12), (name, g, w)


def assert_state_close(got, want, what):
    """Two nests of tensors (a state dict, a training state): the same keys
    and shapes, each float tensor within RTOL of its largest."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            assert_state_close(got[k], want[k], (what, k))
    elif isinstance(want, torch.Tensor):
        assert got.shape == want.shape, what
        if want.is_floating_point() and want.numel():
            top = want.abs().max().item()
            assert (got - want).abs().max().item() <= RTOL * top + 1e-12, what
    else:
        assert got == want, what


@pytest.fixture(scope="module")
def runs(port_tree, tmp_path_factory, monkeypatch_module):  # noqa: F811
    """One process: main_train, main_gencast (one epoch, and two straight),
    GenCast's rollout, main_uncond (one epoch, and two straight). Two ranks
    at 1x2: the same main_train, main_gencast and main_uncond for one epoch,
    the rollout, and the one-process first epochs resumed for a second.
    Then one process resumes the 1x2 first epochs."""
    root = tmp_path_factory.mktemp("tp_trainers_cli")
    monkeypatch_module.setattr(trainer_uncond, "SAMPLE_EVERY", 1)
    train = deeponet_argv(port_tree, root / "{}_train", 2) + ["--mode", "train_test"]
    single = {}
    single["main_train"] = cli.main_train([a.format("one") for a in train], device="cpu")
    cli.main_gencast(gencast_argv(port_tree, root / "one_gencast", 1), device="cpu")
    single["gencast_epoch0"] = ckpt.load_params(gencast_run(root / "one_gencast") / ckpt.STATE_DIR)
    cli.main_gencast(gencast_argv(port_tree, root / "straight_gencast", 2, "train"), device="cpu")
    roll = gencast_argv(port_tree, root / "one_gencast", 1)
    single["rollout"] = cli.main_multistep(roll, device="cpu")
    single["rollout_metrics"] = load(gencast_run(root / "one_gencast"), "multistep_metrics.json")
    uncond = uncond_argv(port_tree, root / "{}_uncond")
    cli.main_uncond([a.format("one") for a in uncond] + ["--num_epochs", "1"], device="cpu")
    cli.main_uncond([a.format("straight") for a in uncond], device="cpu")
    calls = [
        ("main_train", [a.format("mesh") for a in train] + MESH),
        ("main_gencast", gencast_argv(port_tree, root / "mesh_gencast", 1) + MESH),
        ("main_multistep", roll + MESH),
        ("main_gencast", gencast_argv(port_tree, root / "one_gencast", 2, "train") + MESH),
        ("main_uncond", [a.format("mesh") for a in uncond] + ["--num_epochs", "1"] + MESH),
        ("main_uncond", [a.format("one") for a in uncond] + ["--resume", "1"] + MESH),
    ]
    ranks = worker.spawn(dict(kind="cli", calls=calls, constants=CONSTANTS), root / "ranks")
    cli.main_gencast(gencast_argv(port_tree, root / "mesh_gencast", 2, "train"), device="cpu")
    cli.main_uncond([a.format("mesh") for a in uncond] + ["--resume", "1"], device="cpu")
    return root, ranks, single


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_main_train_on_a_model_axis_matches_one_process(runs):
    """``main_train --mesh_shape 1x2``: the run's files, its per-step losses,
    dev and test scores and predictions against one process's; both model
    ranks return the same weights, one process's within RTOL."""
    root, ranks, single = runs
    got_run, want_run = (nonauto_run(deeponet_argv("", root / f"{w}_train", 2))
                         for w in ("mesh", "one"))
    assert result_files(got_run) == result_files(want_run)
    assert_files_close(got_run, want_run, ["train_losses.json", "ckpt-0/dev_loss.json",
                                           "ckpt-1/dev_loss.json", "test/scores.json"])
    np.testing.assert_allclose(np.load(got_run / "test/preds.npy"),
                               np.load(want_run / "test/preds.npy"), rtol=0, atol=1e-5)
    got = [r["states"][0] for r in ranks]
    torch.testing.assert_close(got[0], got[1], rtol=0, atol=0)
    assert_state_close(got[0], worker.returned_state(single["main_train"]), "weights")
    assert "model=2" in ranks[0]["printed"][0]


def test_main_gencast_on_a_model_axis_matches_one_process(runs):
    """``main_gencast --mesh_shape 1x2`` with gradient accumulation and
    checkpointing: its dev and generated-frame scores, its test scores and
    frames against one process's; ``best_model/`` (once resumed for a second
    epoch) holds the one-process layout, within RTOL of two epochs in one
    process; each rank printed its share of the parameters."""
    root, ranks, _ = runs
    got_run, want_run = gencast_run(root / "mesh_gencast"), gencast_run(root / "one_gencast")
    assert_files_close(got_run, want_run, ["ckpt-0/dev_scores.json", "test/scores.json"])
    want = np.load(want_run / "test/preds.npy")
    np.testing.assert_allclose(np.load(got_run / "test/preds.npy"), want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    got_w, want_w = (torch.load(r / trainer_gencast.BEST_DIR / ckpt.MODEL_FILE, weights_only=True)
                     for r in (got_run, gencast_run(root / "straight_gencast")))
    assert_state_close(got_w, want_w, "best_model")
    for r in ranks:
        assert " on this rank)" in r["printed"][1]


def test_gencast_rollout_on_a_model_axis_matches_one_process(runs):
    """GenCast's ``main_multistep --mesh_shape 1x2`` from one process's
    checkpoint, its PUNetG split: both ranks' frames and the per-step
    metrics against one process's rollout."""
    root, ranks, single = runs
    want = single["rollout"]
    for r in ranks:
        assert "tensor-sharding params over 2" in r["printed"][2]
        got = r["frames"][0]
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()
    got = load(gencast_run(root / "one_gencast"), "multistep_metrics.json")
    assert_close_metrics(got, single["rollout_metrics"])


def assert_close_metrics(got, want):
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        for k in w:
            assert math.isclose(g[k], w[k], rel_tol=RTOL), (k, g[k], w[k])


@pytest.mark.parametrize("first", ["mesh", "one"])
def test_gencast_resumes_across_meshes(runs, first):
    """One epoch on one mesh (1x2, or one process), the second resumed on
    the other, against two epochs in one process: the second epoch's dev
    scores and the training state (the weights, the flat moments and the
    accumulator, held mid-accumulation at the first epoch's end, in the
    one-process layout)."""
    root, _, single = runs
    got_run, want_run = gencast_run(root / f"{first}_gencast"), gencast_run(root / "straight_gencast")
    assert_files_close(got_run, want_run, ["ckpt-1/dev_scores.json"])
    got, want = (ckpt.load_params(r / ckpt.STATE_DIR) for r in (got_run, want_run))
    assert_state_close(got, want, "training_state")
    crossing = single["gencast_epoch0"]["optimizer"]  # what the second epoch resumed from
    assert crossing["param_groups"][0]["mini_step"] == 1
    assert crossing["state"][0]["acc"].abs().max() > 0


@pytest.mark.parametrize("first", ["mesh", "one"])
def test_uncond_resumes_across_meshes(runs, first):
    """``main_uncond``, one epoch on one mesh and the second resumed on the
    other, against two epochs in one process: the per-step losses, the
    training state and ``ema_model/``, in the one-process layout; each
    epoch's samples plotted once, by rank 0."""
    root = runs[0]
    got_run, want_run = uncond_run(root / f"{first}_uncond"), uncond_run(root / "straight_uncond")
    assert_files_close(got_run, want_run, ["train_losses.json"])
    assert result_files(got_run) == result_files(want_run)
    for name in (ckpt.STATE_DIR, trainer_uncond.EMA_DIR):
        assert_state_close(ckpt.load_params(got_run / name), ckpt.load_params(want_run / name),
                           name)
    assert {p.name for p in got_run.glob("samples-ep*.png")} == {"samples-ep0.png",
                                                                "samples-ep1.png"}
