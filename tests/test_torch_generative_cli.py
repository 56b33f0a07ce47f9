"""Pixel diffusion through both packages' entry points, end to end on the
same weights, with JAX's draws injected into the port
(``tests/test_torch_diffusion.py::inject_jax_draws``): ``main_auto --mode
train_test`` (per-step losses, generated-frame dev scores, test scores and
frames) and ``main_multistep`` on the checkpoint that
``scripts/export_torch_checkpoint.py`` carried over (per-step metrics),
all within rel 1e-4; ``--resume``; and the flags the generative entry
points take or refuse. GenCast's are in ``test_torch_gencast_cli.py``."""

import importlib.util
import json

import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_auto as jax_main_auto
from cfdbench_tpu.cli import main_multistep as jax_main_multistep
from cfdbench_tpu.models import diffusion as jax_diffusion
from cfdbench_tpu.models.punetg import PUNetGCFD as JaxPUNetG
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_pixel_diffusion
from cfdbench_tpu_torch.utils.artifacts import get_output_dir
from cfdbench_tpu_torch.utils.flax_import import params_to_flax
from tests.test_torch_diffusion import inject_jax_draws
from tests.test_torch_multistep import REPO, assert_metrics_close
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

# A narrow PUNetG, 10 train timesteps, 2 denoising steps a frame.
GEN_FLAGS = ["--pixel_diffusion_base_channels", "8", "--pixel_diffusion_channel_mults", "1", "2",
             "--pixel_diffusion_num_res_blocks", "1", "--ldm_noise_scheduler_timesteps", "10",
             "--ldm_num_inference_steps", "2", "--num_rows", "16", "--num_cols", "16"]


def gen_argv(model, data_root, epochs, out):
    return ["--model", model] + GEN_FLAGS + [
        "--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
        "--output_dir", str(out), "--num_epochs", str(epochs), "--batch_size", "16",
        "--eval_batch_size", "16", "--eval_interval", "1", "--log_interval", "100",
        "--mesh_shape", "1"]


def run_of(argv):
    return get_output_dir(Args.parse_args(argv), is_auto=True)


def jax_unet(in_chan):
    """The JAX package's PUNetG at GEN_FLAGS' widths (for its dropout masks)."""
    return JaxPUNetG(in_channels=in_chan, out_channels=2, base_channels=8, channel_mults=(1, 2),
                     num_res_blocks=1, dropout=0.1)


def load(run, name):
    return json.loads((run / name).read_text())


def export(argv):
    """``scripts/export_torch_checkpoint.py`` on a JAX run."""
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", REPO / "scripts" / "export_torch_checkpoint.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.main(argv)


def assert_scores_close(got, want, what):
    assert got.keys() == want.keys(), what
    assert_close_rel(list(got.values()), list(want.values()), what)


@pytest.fixture(scope="module")
def pixel_runs(port_tree, tmp_path_factory):
    """Both packages' ``main_auto --mode train_test``, 2 epochs, dropout on,
    from the port's init (handed to the JAX task in place of its own) and
    JAX's draws. Returns the JAX run's argv and both runs."""
    root = tmp_path_factory.mktemp("pixel")
    argv = gen_argv("pixel_diffusion", port_tree, 2, root / "jax")
    task = init_pixel_diffusion(Args.parse_args(argv), 5)
    params = params_to_flax(task.model.state_dict())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_diffusion.PixelDiffusionCfdModel, "init_variables",
                   lambda self, rng, sample: (params, {}))
        # No example.png: one more sampler for the JAX package to compile.
        jax_main_auto(argv + ["--mode", "train_test", "--plot_train_examples", "0"])
        inject_jax_draws(mp, jax_unet(2))
        port_argv = gen_argv("pixel_diffusion", port_tree, 2, root / "port")
        cli.main_auto(port_argv + ["--mode", "train_test", "--plot_train_examples", "0"],
                      device="cpu")
    return argv, run_of(argv), run_of(port_argv)


def test_main_auto_pixel_diffusion_matches_jax_end_to_end(pixel_runs):
    """The JAX main_auto's file set and JSON layout; per-step train losses;
    each epoch's dev scores, which are those of generated frames beside
    the masked persistence baseline; the test scores and frames."""
    _, want_run, got_run = pixel_runs
    files = result_files(got_run)
    assert files == result_files(want_run)
    assert {"ckpt-1/model.pt", "ckpt-1/dev_scores.json", "training_state/model.pt",
            "test/preds.npy", "test/scores.json"} <= files
    for f in sorted(f for f in files if f.endswith(".json") and "args" not in f):
        assert json_shape(load(got_run, f)) == json_shape(load(want_run, f)), f
    assert_close_rel(load(got_run, "train_losses.json"), load(want_run, "train_losses.json"),
                     "train losses")
    for ep in (0, 1):
        got, want = (load(r, f"ckpt-{ep}/dev_scores.json")["mean"] for r in (got_run, want_run))
        assert_scores_close(got, want, f"dev {ep}")
        assert got["nmse"] != got["input_nmse"]  # generated frames, not persistence
    assert_scores_close(load(got_run, "test/scores.json")["mean"],
                        load(want_run, "test/scores.json")["mean"], "test scores")
    got, want = (np.load(r / "test/preds.npy") for r in (got_run, want_run))
    assert got.shape == want.shape and got.shape[1:] == (16, 16, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_main_multistep_pixel_diffusion_matches_jax(pixel_runs, monkeypatch):
    """The JAX run's best checkpoint carried over by the export script:
    both packages' stochastic 20-step rollouts (fresh noise each step, keyed
    by --seed) give the same per-step metrics."""
    argv, run, _ = pixel_runs
    assert export(argv).name == "model.pt"
    inject_jax_draws(monkeypatch)
    out = run / "multistep_metrics.json"
    jax_main_multistep(argv)
    want = json.loads(out.read_text())
    out.unlink()
    frames = cli.main_multistep(argv, device="cpu")
    assert frames.shape[0] == 20 and frames.shape[2:] == (16, 16, 2)
    assert torch.isfinite(frames).all()
    assert_metrics_close(json.loads(out.read_text()), want)


def test_pixel_diffusion_resume_continues_as_one_run(port_tree, tmp_path):
    """Dropout on and every draw keyed by (seed, step): one epoch, then
    --resume for a second, gives a straight two-epoch run's per-step losses
    and weights bit for bit."""
    argv = gen_argv("pixel_diffusion", port_tree, 2, tmp_path) + [
        "--mode", "train", "--plot_train_examples", "0"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    cli.main_auto(argv + ["--output_dir", str(straight)], device="cpu")
    cli.main_auto(argv + ["--output_dir", str(resumed), "--num_epochs", "1"], device="cpu")
    cli.main_auto(argv + ["--output_dir", str(resumed), "--resume", "1"], device="cpu")
    runs = [run_of(argv + ["--output_dir", str(d)]) for d in (straight, resumed)]
    losses = [load(r, "train_losses.json") for r in runs]
    assert len(losses[0]) > 2 and losses[0] == losses[1]
    for name in ("ckpt-1/model.pt", "training_state/model.pt"):
        got, want = (torch.load(r / name, weights_only=True) for r in runs)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("regime,argv", [
    ("auto", ["--model", "pixel_diffusion", "--use_gradient_checkpointing"]),
    ("gencast", ["--model", "gencast", "--use_gradient_checkpointing",
                 "--gradient_accumulation_steps", "4"]),
])
def test_entry_points_take_the_flags_jax_applies(regime, argv):
    # The JAX package applies remat to the PUNetG models (cli.py:96, :784)
    # and passes the accumulation to the GenCast trainer (cli.py:801).
    cli.check_training_flags(Args.parse_args(argv), regime)


@pytest.mark.parametrize("entry,flags,error", [
    ("main_auto", ["--model", "pixel_diffusion", "--gradient_accumulation_steps", "2"],
     "main_auto ignores it .ROADMAP.md C"),
    # The latent models and --use_mixed_precision are ported
    # (tests/test_torch_mixed_precision.py); these cases keep their ids.
    pytest.param("main_auto", ["--model", "latent_diffusion2", "--use_gradient_checkpointing"],
                 "main_auto ignores it .ROADMAP.md C", id="main_auto-flags2-A13b"),
    pytest.param("main_gencast", ["--opt_state_dtype", "bf16"],
                 "main_gencast ignores it .ROADMAP.md C",
                 id="main_gencast-flags4-main_gencast ignores it .ROADMAP.md C"),
    pytest.param("main_gencast", ["--measure_time", "1"], "main_gencast ignores it .ROADMAP.md C",
                 id="main_gencast-flags5-main_gencast ignores it .ROADMAP.md C"),
    # A data and a model axis are ported (tests/test_torch_parallel_trainers.py,
    # tests/test_torch_tp_trainers*.py); pipeline parallelism stages the FNO in
    # main_auto alone. The case keeps its id.
    pytest.param("main_gencast", ["--mesh_shape", "2x2", "--pp_microbatches", "2"], "A15e",
                 id="main_gencast-flags6-A15"),
    # The JAX main_multistep prints that a diffusion rollout runs float32.
    pytest.param("main_multistep", ["--model", "latent_diffusion_lite", "--rollout_dtype",
                                    "bfloat16"], "with --model latent_diffusion_lite.*ROADMAP.md C",
                 id="main_multistep-flags7-A13b"),
])
def test_generative_entry_points_refuse_unported_flags(tmp_path, entry, flags, error):
    argv = ["--data_dir", str(tmp_path / "data"), "--output_dir", str(tmp_path / "out")] + flags
    with pytest.raises(NotImplementedError, match=error):
        getattr(cli, entry)(argv, device="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("entry,model,names", [
    ("main_auto", "gencast", "main_gencast"), ("main_train", "pixel_diffusion", "main_auto"),
])
def test_entry_points_name_the_one_that_trains_a_generative_model(tmp_path, entry, model, names):
    argv = ["--model", model, "--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "o")]
    with pytest.raises(ValueError, match=f"Invalid model name: {model} .*{names}"):
        getattr(cli, entry)(argv, device="cpu")
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("entry,model", [
    ("main_auto", "pixel_diffusion"), ("main_multistep", "pixel_diffusion"),
    ("main_gencast", "gencast"), ("main_multistep", "gencast"),
])
def test_generative_entry_points_need_a_card(port_tree, tmp_path, monkeypatch, entry, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = gen_argv(model, port_tree, 1, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        getattr(cli, entry)(argv)
    assert not any(tmp_path.iterdir())
