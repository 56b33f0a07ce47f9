"""GenCast through both packages' entry points, end to end on the same
weights, with JAX's draws injected into the port
(``tests/test_torch_diffusion.py::inject_jax_draws``): ``main_gencast``
with gradient accumulation and checkpointing, the port's resumed after its
first epoch (per-step train losses, dev and test scores), and
``main_multistep``'s two-frame-window rollout on the ``best_model/`` that
``scripts/export_torch_checkpoint.py`` carried over (per-step metrics), all
within rel 1e-4."""

import json

import jax
import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_gencast as jax_main_gencast
from cfdbench_tpu.cli import main_multistep as jax_main_multistep
from cfdbench_tpu.models import diffusion as jax_diffusion
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.data.wrapper import compute_residual_stats, wrap_gencast
from cfdbench_tpu_torch.models import diffusion, init_gencast
from cfdbench_tpu_torch.utils.flax_import import params_to_flax
from tests.test_torch_diffusion import inject_jax_draws
from tests.test_torch_generative_cli import (
    assert_scores_close,
    export,
    gen_argv,
    jax_unet,
    load,
    run_of,
)
from tests.test_torch_multistep import assert_metrics_close
from tests.test_torch_train import (  # noqa: F401  (port_tree is a fixture)
    assert_close_rel,
    json_shape,
    port_tree,
    result_files,
)

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gencast_runs(port_tree, tmp_path_factory):
    """Both packages' ``main_gencast --mode train_test`` for 2 epochs with
    ``--gradient_accumulation_steps 2 --use_gradient_checkpointing 1``; the
    port's in two runs, one epoch of training, then one that resumes from
    its snapshot, trains the second epoch and tests. Returns the argv, both
    runs and both packages' per-micro-step train mse."""
    root = tmp_path_factory.mktemp("gencast")
    flags = ["--gradient_accumulation_steps", "2", "--use_gradient_checkpointing", "1"]
    argv = gen_argv("gencast", port_tree, 2, root / "jax") + flags
    port_argv = gen_argv("gencast", port_tree, 2, root / "port") + flags
    train, _, _ = cli.get_auto_dataset(port_tree, "cavity_prop_bc_geo", 0.1, True, True,
                                       load_splits=["train"])
    task = init_gencast(Args.parse_args(argv), compute_residual_stats(wrap_gencast(train)), 5)
    params = params_to_flax(task.model.state_dict())
    losses = {"jax": [], "port": []}
    jax_loss_scores = jax_diffusion.GenCastCfdModel.loss_scores
    port_loss_scores = diffusion.GenCastCfdModel.loss_scores

    def jax_recording(self, p, batch, model_state=None, train=False, rng=None):
        out = jax_loss_scores(self, p, batch, model_state, train, rng)
        if train:
            jax.debug.callback(lambda v: losses["jax"].append(float(v)), out[1][0]["mse"])
        return out

    def port_recording(self, batch, key=None):
        out = port_loss_scores(self, batch, key)
        if key is not None:
            losses["port"].append(out[1]["mse"].item())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_diffusion.GenCastCfdModel, "init_variables",
                   lambda self, rng, sample: (params, {}))
        mp.setattr(jax_diffusion.GenCastCfdModel, "loss_scores", jax_recording)
        jax_main_gencast(argv + ["--mode", "train_test"])
        inject_jax_draws(mp, jax_unet(6))
        mp.setattr(diffusion.GenCastCfdModel, "loss_scores", port_recording)
        cli.main_gencast(port_argv + ["--mode", "train", "--num_epochs", "1"], device="cpu")
        cli.main_gencast(port_argv + ["--mode", "train_test"], device="cpu")
    return argv, run_of(argv), run_of(port_argv), losses


def test_main_gencast_matches_jax_end_to_end(gencast_runs):
    """The JAX main_gencast's file set and JSON layout; every micro-step's
    train mse, the port's across its resume; each epoch's dev scores (noise
    prediction, persistence baseline, generated frames), the best and last
    dev nmse; the test scores and frames."""
    _, want_run, got_run, losses = gencast_runs
    files = result_files(got_run)
    assert files == result_files(want_run)
    assert {"residual_stats.npz", "best_model/model.pt", "ckpt-1/dev_scores.json",
            "training_state/model.pt", "test/preds.npy", "test/scores.json"} <= files
    for f in sorted(f for f in files if f.endswith(".json")):
        assert json_shape(load(got_run, f)) == json_shape(load(want_run, f)), f
    assert len(losses["port"]) > 4
    assert_close_rel(losses["port"], losses["jax"], "train mse")
    for ep in (0, 1):
        got, want = (load(r, f"ckpt-{ep}/dev_scores.json")["mean"] for r in (got_run, want_run))
        assert "gen_frame_nmse" in got
        assert_scores_close(got, want, f"dev {ep}")
    got, want = (load(r, "training_meta.json") for r in (got_run, want_run))
    assert got["epoch"] == want["epoch"] == 1
    assert_close_rel([got["best_nmse"], got["dev_nmse"]], [want["best_nmse"], want["dev_nmse"]],
                     "training_meta")
    assert_scores_close(load(got_run, "test/scores.json")["mean"],
                        load(want_run, "test/scores.json")["mean"], "test scores")
    got, want = (np.load(r / "test/preds.npy") for r in (got_run, want_run))
    assert got.shape == want.shape and got.shape[1:] == (16, 16, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_main_multistep_gencast_matches_jax(gencast_runs, monkeypatch):
    """The JAX run's ``best_model/`` carried over by the export script: both
    packages' two-frame-window rollouts from (frame0, frame0) give the same
    per-step metrics."""
    argv, run, _, _ = gencast_runs
    assert export(argv) == run / "best_model" / "model.pt"
    inject_jax_draws(monkeypatch)
    out = run / "multistep_metrics.json"
    jax_main_multistep(argv)
    want = json.loads(out.read_text())
    out.unlink()
    frames = cli.main_multistep(argv, device="cpu")
    assert frames.shape[0] == 20 and torch.isfinite(frames).all()
    assert_metrics_close(json.loads(out.read_text()), want)
