"""The non-autoregressive FFN and DeepONet through both packages' entry
points, end to end: ``main_train --mode train_test`` from the same
weights and JAX's own query draws, ``--resume``, and the non-auto branch
of ``main_multistep`` on cavity and on dam's odd grid (per-step numbers
within rel 1e-4), with the flags ``main_train`` refuses and the entry
point that each kind of model needs."""

import json

import jax
import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_multistep as jax_main_multistep
from cfdbench_tpu.cli import main_train as jax_main_train
from cfdbench_tpu.training import trainer_nonauto as jax_trainer
from cfdbench_tpu.training.checkpoints import save_params as jax_save_params
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_nonauto_model
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.training import trainer_nonauto
from cfdbench_tpu_torch.utils.flax_import import params_to_flax
from tests.test_torch_multistep import assert_metrics_close
from tests.test_torch_nonauto import NONAUTO_FLAGS
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


def train_argv(name, data_root, epochs, eval_interval=1, data_name="cavity_prop_bc_geo"):
    return NONAUTO_FLAGS[name] + [
        "--data_name", data_name, "--data_dir", str(data_root),
        "--num_epochs", str(epochs), "--batch_size", "16", "--eval_interval",
        str(eval_interval), "--log_interval", "100", "--mesh_shape", "1",
    ]


def nonauto_run(argv):
    from cfdbench_tpu_torch.utils.artifacts import get_output_dir

    return get_output_dir(Args.parse_args(argv), is_auto=False)


def jax_draws(seed, step, k, height, width):
    """The JAX trainer's query points of global step ``step``
    (``trainer_nonauto.py:88-97``), as the port's sampler returns them."""
    r1, r2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed + 777), step))
    return torch.from_numpy(np.stack([np.asarray(jax.random.randint(r1, (k,), 0, height)),
                                      np.asarray(jax.random.randint(r2, (k,), 0, width))],
                                     axis=-1).astype(np.int64))


@pytest.mark.parametrize("name", list(NONAUTO_FLAGS))
def test_main_train_matches_jax_end_to_end(port_tree, tmp_path, monkeypatch, name):
    """--mode train_test, 2 epochs, from the weights the port's CLI draws
    (handed to the JAX trainer in place of its init) and JAX's own query
    draws: the JAX main_train's file set and JSON layout, its per-step
    train losses, ``ckpt-*/dev_loss.json``, test scores and predictions."""
    argv = train_argv(name, port_tree, 2) + ["--mode", "train_test"]
    start = init_nonauto_model(Args.parse_args(argv), n_case_params=5).state_dict()
    params = params_to_flax(start)
    monkeypatch.setattr(jax_trainer.NonAutoTask, "init_params", lambda self, rng, s: params)
    monkeypatch.setattr(trainer_nonauto, "sample_query_idxs", jax_draws)
    jax_main_train(argv + ["--output_dir", str(tmp_path / "jax")])
    cli.main_train(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")

    want_run = nonauto_run(argv + ["--output_dir", str(tmp_path / "jax")])
    got_run = nonauto_run(argv + ["--output_dir", str(tmp_path / "port")])
    assert "non-auto" in got_run.parts
    files = result_files(got_run)
    assert files == result_files(want_run)
    assert {"ckpt-1/model.pt", "ckpt-1/dev_loss.json", "training_state/model.pt",
            "test/preds.npy", "test/scores.json"} <= files
    load = lambda run, f: json.loads((run / f).read_text())  # noqa: E731
    for f in sorted(f for f in files if f.endswith(".json")):
        assert json_shape(load(got_run, f)) == json_shape(load(want_run, f)), f
    assert_close_rel(load(got_run, "train_losses.json"), load(want_run, "train_losses.json"),
                     "train losses")
    for ep in (0, 1):
        got, want = (load(r, f"ckpt-{ep}/dev_loss.json") for r in (got_run, want_run))
        assert_close_rel(list(got["mean"].values()), list(want["mean"].values()), f"dev {ep}")
    got, want = load(got_run, "test/scores.json"), load(want_run, "test/scores.json")
    assert_close_rel(list(got["mean"].values()), list(want["mean"].values()), "test scores")
    got_preds, want_preds = (np.load(r / "test/preds.npy") for r in (got_run, want_run))
    assert got_preds.shape == want_preds.shape == (got_preds.shape[0], 16, 16, 1)
    np.testing.assert_allclose(got_preds, want_preds, rtol=0, atol=1e-4)


def test_deeponet_resume_continues_as_one_run(port_tree, tmp_path):
    """One epoch, then --resume to two, against two straight: the same
    per-step losses (the same query draws), weights and optimizer state."""
    argv = train_argv("deeponet", port_tree, 2) + ["--mode", "train"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    cli.main_train(argv + ["--output_dir", str(straight)], device="cpu")
    cli.main_train(argv + ["--output_dir", str(resumed), "--num_epochs", "1"], device="cpu")
    cli.main_train(argv + ["--output_dir", str(resumed), "--resume", "1"], device="cpu")
    got_run, want_run = (nonauto_run(argv + ["--output_dir", str(r)])
                         for r in (resumed, straight))
    want = json.loads((want_run / "train_losses.json").read_text())
    assert json.loads((got_run / "train_losses.json").read_text()) == want
    for f in ("ckpt-1/model.pt", "training_state/model.pt"):
        torch.testing.assert_close(torch.load(got_run / f, weights_only=True),
                                   torch.load(want_run / f, weights_only=True), rtol=0, atol=0)


@pytest.mark.parametrize("name,data_name", [
    ("ffn", "cavity_prop_bc_geo"), ("deeponet", "cavity_prop_bc_geo"),
    ("ffn", "dam_prop_bc_geo"), ("deeponet", "dam_prop_bc_geo"),  # dam: 18x17
])
def test_main_multistep_matches_jax_end_to_end(synth_root, tmp_path, name, data_name):
    """One checkpoint in both layouts under ``non-auto/``: both packages'
    20 per-step metrics within rel 1e-4."""
    argv = train_argv(name, synth_root, 1, data_name=data_name) + [
        "--output_dir", str(tmp_path), "--act_on_output", "1"]
    run = nonauto_run(argv)
    P = 8 if "cylinder" in data_name else 5
    sd = init_nonauto_model(Args.parse_args(argv), n_case_params=P,
                            generator=torch.Generator().manual_seed(3)).state_dict()
    jax_save_params({"params": params_to_flax(sd)}, run / "ckpt-0")
    ckpt.save_checkpoint(sd, run / "ckpt-0", ep=0, dev_loss=0.0)
    out = run / "multistep_metrics.json"
    jax_main_multistep(argv)
    want = json.loads(out.read_text())
    out.unlink()
    frames = cli.main_multistep(argv, device="cpu")
    got = json.loads(out.read_text())
    H, W = (18, 17) if data_name.startswith("dam") else (16, 16)
    assert frames.shape[0] == 20 and frames.shape[2:] == (H, W, 1)
    assert len(got) == 20
    assert_metrics_close(got, want)


def test_main_multistep_nonauto_refuses_a_mesh(synth_root, tmp_path):
    # The JAX non-auto branch ignores --mesh_shape (VERDICT.md weak #5).
    argv = train_argv("ffn", synth_root, 1) + ["--output_dir", str(tmp_path),
                                                "--mesh_shape", "2x1"]
    with pytest.raises(NotImplementedError, match="A15"):
        cli.main_multistep(argv, device="cpu")


def test_main_train_needs_a_card_unless_told_cpu(port_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = train_argv("ffn", port_tree, 1) + ["--output_dir", str(tmp_path), "--mode", "train"]
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        cli.main_train(argv)
    assert not any(tmp_path.iterdir())
    cli.main_train(argv, device="cpu")
    run = nonauto_run(argv)
    assert (run / "ckpt-0" / "model.pt").exists() and not (run / "test").exists()
    # --mode test alone scores the checkpoint that training left.
    cli.main_train(argv + ["--mode", "test"], device="cpu")
    assert "nmse" in json.loads((run / "test" / "scores.json").read_text())["mean"]


@pytest.mark.parametrize("flags,error", [
    (["--use_mixed_precision"], "main_train ignores it .ROADMAP.md C"),
    (["--opt_state_dtype", "bf16"], "main_train ignores it .ROADMAP.md C"),
    (["--opt_state_dtype", "factored"], "main_train ignores it .ROADMAP.md C"),
    (["--gradient_accumulation_steps", "2"], "main_train ignores it .ROADMAP.md C"),
    (["--use_gradient_checkpointing"], "main_train ignores it .ROADMAP.md C"),
    (["--cache_dir", "cache"], "main_train ignores it .ROADMAP.md C"),
    (["--pp_microbatches", "2"], "A15"),
    (["--shard_spatial", "1"], "A15"),
    (["--mesh_shape", "2x1"], "A15"),
    (["--profile_dir", "trace"], "A7"),
    (["--model", "latent_diffusion_lite"], "A13"),
])
def test_main_train_refuses_unported_flags(tmp_path, flags, error):
    argv = train_argv("deeponet", tmp_path / "data", 1) + [
        "--output_dir", str(tmp_path / "out")] + flags
    with pytest.raises(NotImplementedError, match=error):
        cli.main_train(argv, device="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("entry,model,names", [
    ("main_auto", "ffn", "main_train"), ("main_auto", "deeponet", "main_train"),
    ("main_train", "fno", "main_auto"), ("main_train", "auto_deeponet", "main_auto"),
])
def test_entry_points_name_the_one_that_trains_a_model(tmp_path, entry, model, names):
    # The JAX package raises "Invalid model name" here, without a hint.
    argv = ["--model", model, "--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "o")]
    with pytest.raises(ValueError, match=f"Invalid model name: {model} .*{names}"):
        getattr(cli, entry)(argv, device="cpu")
    assert not (tmp_path / "o").exists()
