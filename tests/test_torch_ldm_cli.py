"""The two-stage latent diffusion pipeline through both packages' entry
points on a 16x16 tree: ``main_vae`` (a lite VAE, the port's init handed to
the JAX trainer, JAX's posterior draws injected into the port), then
``main_auto --model latent_diffusion2 --mode train_test`` on the JAX VAE
(carried to the port by ``scripts/export_torch_checkpoint.py`` with the
LDM's checkpoint), then ``main_multistep``: per-step and per-epoch numbers
within rel 1e-4. Also: the port refuses a VAE directory that holds only
JAX weights with the export command; both packages fail on an LDM over a
VAE variant other than lite (ROADMAP.md C); the JAX package never applies
``--use_gradient_checkpointing`` to an LDM, which the port refuses;
``train_ldm_torch.py`` defaults to ``latent_diffusion2``; the entry points
need a card."""

import json
import runpy
import sys

import numpy as np
import pytest
import torch

from cfdbench_tpu import cli as jax_cli
from cfdbench_tpu.config import Args as JaxArgs
from cfdbench_tpu.models import diffusion as jax_diffusion
from cfdbench_tpu.models import vae as jax_vae
from cfdbench_tpu.training.checkpoints import save_params as jax_save_params
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_latent_diffusion, make_cfd_vae
from cfdbench_tpu_torch.utils.artifacts import get_output_dir
from cfdbench_tpu_torch.utils.flax_import import params_to_flax
from tests.test_torch_diffusion import four_groups, inject_jax_draws
from tests.test_torch_generative_cli import assert_scores_close, export, load
from tests.test_torch_multistep import REPO, assert_metrics_close
from tests.test_torch_train import assert_close_rel, json_shape, result_files
from tests.test_torch_vae import inject_posterior_noise, tiny_tree  # noqa: F401  (a fixture)

torch.set_num_threads(1)

# A narrow latent UNet of one level (the 16x16 grid's latents are 2x2),
# 10 train timesteps, 2 denoising steps a frame.
LDM_FLAGS = ["--unet_base_channels", "8", "--unet_channel_mult", "1",
             "--unet_num_res_blocks", "1", "--ldm_noise_scheduler_timesteps", "10",
             "--ldm_num_inference_steps", "2", "--num_rows", "16", "--num_cols", "16"]


def common(data_root, out, weights):
    return ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(out), "--ldm_vae_weights_path", str(weights),
            "--batch_size", "16", "--mesh_shape", "1"]


def ldm_argv(data_root, out, weights, model="latent_diffusion2"):
    return ["--model", model] + LDM_FLAGS + common(data_root, out, weights) + [
        "--num_epochs", "2", "--eval_batch_size", "16", "--eval_interval", "1",
        "--log_interval", "100"]


@pytest.fixture(scope="module")
def pipeline(tiny_tree, tmp_path_factory):
    """Both packages' main_vae (1 epoch), then main_auto --mode train_test
    (2 epochs) for latent_diffusion2 on the JAX VAE, four groups a PUNetG
    GroupNorm. Returns the JAX LDM run's argv and the runs' directories."""
    root = tmp_path_factory.mktemp("ldm")
    vae_flags = ["--num_epochs", "1"]
    vae = make_cfd_vae("lite", generator=torch.Generator().manual_seed(0))
    vae_params = params_to_flax(vae.state_dict())
    argv = ldm_argv(tiny_tree, root / "jax", root / "jax_vae")
    port_argv = ldm_argv(tiny_tree, root / "port", root / "jax_vae")
    task = init_latent_diffusion(Args.parse_args(argv), 5, vae.state_dict())
    params = params_to_flax(task.model.state_dict())
    with pytest.MonkeyPatch.context() as mp:
        four_groups(mp)
        mp.setattr(jax_vae.AutoencoderKL, "init", lambda self, *a, **k: {"params": vae_params})
        jax_cli.main_vae(common(tiny_tree, root / "jax", root / "jax_vae") + vae_flags)
        mp.setattr(jax_diffusion.LatentDiffusionCfdModel2, "init_variables",
                   lambda self, rng, sample: (params, {}))
        jax_cli.main_auto(argv + ["--mode", "train_test", "--plot_train_examples", "0"])
        assert export(argv).name == "model.pt"
        inject_posterior_noise(mp)
        inject_jax_draws(mp)
        cli.main_vae(common(tiny_tree, root / "port", root / "port_vae") + vae_flags,
                     device="cpu")
        cli.main_auto(port_argv + ["--mode", "train_test", "--plot_train_examples", "0"],
                      device="cpu")
    runs = {pkg: dict(vae=root / pkg / "vae" / "cavity_prop_bc_geo",
                      ldm=get_output_dir(Args.parse_args(a), is_auto=True))
            for pkg, a in (("jax", argv), ("port", port_argv))}
    return argv, runs, root


def test_main_vae_matches_jax(pipeline):
    """The lite VAE's per-step losses and per-epoch validation; the port's
    best weights are a host state dict beside JAX's."""
    _, runs, root = pipeline
    got, want = (load(runs[p]["vae"], "loss_history.json") for p in ("port", "jax"))
    assert got.keys() == want.keys() and got["val_steps"] == want["val_steps"]
    for k in got:
        assert_close_rel(got[k], want[k], k)
    assert (root / "port_vae" / "model.pt").exists()
    assert {p.name for p in (root / "jax_vae").iterdir()} >= {"model.pt"}


def test_main_auto_latent_diffusion2_matches_jax(pipeline):
    """The JAX main_auto's file set and JSON layout; per-step train losses;
    each epoch's dev scores of generated frames beside persistence; the
    test scores and frames."""
    _, runs, _ = pipeline
    want_run, got_run = runs["jax"]["ldm"], runs["port"]["ldm"]
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
    assert_scores_close(load(got_run, "test/scores.json")["mean"],
                        load(want_run, "test/scores.json")["mean"], "test scores")
    got, want = (np.load(r / "test/preds.npy") for r in (got_run, want_run))
    assert got.shape == want.shape and got.shape[1:] == (16, 16, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # The frozen VAE is no part of the LDM's checkpoint.
    sd = torch.load(got_run / "ckpt-1" / "model.pt", weights_only=True)
    assert {k.split(".")[0] for k in sd} == {"unet"}


def test_main_multistep_latent_diffusion2_matches_jax(pipeline, monkeypatch):
    """Both packages' 20-step rollouts of the JAX run's best checkpoint
    (carried by the export script), fresh noise each step."""
    argv, runs, _ = pipeline
    four_groups(monkeypatch)
    inject_jax_draws(monkeypatch)
    out = runs["jax"]["ldm"] / "multistep_metrics.json"
    jax_cli.main_multistep(argv)
    want = json.loads(out.read_text())
    out.unlink()
    frames = cli.main_multistep(argv, device="cpu")
    assert frames.shape[0] == 20 and frames.shape[2:] == (16, 16, 2)
    assert torch.isfinite(frames).all()
    assert_metrics_close(json.loads(out.read_text()), want)


def test_port_refuses_a_vae_directory_of_jax_weights(tiny_tree, tmp_path):
    """A ``--ldm_vae_weights_path`` that holds only the JAX package's
    weights raises with the export command."""
    vae = make_cfd_vae("lite", generator=torch.Generator().manual_seed(0))
    jax_save_params({"params": params_to_flax(vae.state_dict())}, tmp_path / "w")
    argv = ldm_argv(tiny_tree, tmp_path / "out", tmp_path / "w") + ["--mode", "train"]
    with pytest.raises(FileNotFoundError, match="holds JAX weights .*export_torch_checkpoint"):
        cli.main_auto(argv, device="cpu")


def test_ldm_on_another_vae_variant_fails_in_both_packages(tiny_tree, tmp_path):
    """The JAX task decodes with a lite VAE whatever ``--vae_variant`` says
    (``diffusion.py:375, 584``) but restores the weights into a template of
    that variant (``cli.py:113-134``): v1 weights load, then fail on the
    lite VAE's shapes. The port refuses by name before writing anything."""
    from flax.errors import ScopeParamShapeError

    vae = make_cfd_vae("v1", generator=torch.Generator().manual_seed(0))
    jax_save_params({"params": params_to_flax(vae.state_dict())}, tmp_path / "w")
    argv = ldm_argv(tiny_tree, tmp_path / "out", tmp_path / "w", "latent_diffusion_lite") + [
        "--vae_variant", "v1", "--mode", "train", "--num_epochs", "1"]
    with pytest.raises(ScopeParamShapeError):
        jax_cli.main_auto(argv)
    with pytest.raises(ValueError, match="--vae_variant v1 with --model latent_diffusion_lite"
                                         ".*ROADMAP.md C"):
        cli.main_auto(argv[:argv.index("--output_dir") + 1] + [str(tmp_path / "port")]
                      + argv[argv.index("--output_dir") + 2:], device="cpu")
    assert not (tmp_path / "port").exists()


def test_jax_ldm_ignores_gradient_checkpointing(pipeline):
    """``make_auto_task`` applies remat to pixel diffusion only: an LDM task
    built with the flag does not checkpoint. The port refuses the flag."""
    argv, _, _ = pipeline
    args = JaxArgs.parse_args(argv + ["--use_gradient_checkpointing"])
    task = jax_cli.make_auto_task(args, n_case_params=5, field_shape=(16, 16))
    assert not task.use_gradient_checkpointing
    with pytest.raises(NotImplementedError, match="use_gradient_checkpointing.*ROADMAP.md C"):
        cli.check_training_flags(Args.parse_args(argv + ["--use_gradient_checkpointing"]))


def test_train_ldm_torch_defaults_to_latent_diffusion2(monkeypatch):
    calls = []
    monkeypatch.setattr(cli, "main_auto", lambda argv: calls.append(argv))
    for argv in ([], ["--model", "latent_diffusion_lite"]):
        monkeypatch.setattr(sys, "argv", ["train_ldm_torch.py"] + argv)
        runpy.run_path(str(REPO / "train_ldm_torch.py"), run_name="__main__")
    assert calls == [["--model", "latent_diffusion2"], ["--model", "latent_diffusion_lite"]]


@pytest.mark.parametrize("entry", ["main_vae", "main_auto", "main_multistep"])
def test_ldm_entry_points_need_a_card(tiny_tree, tmp_path, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (common(tiny_tree, tmp_path, tmp_path / "w") if entry == "main_vae"
            else ldm_argv(tiny_tree, tmp_path, tmp_path / "w"))
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        getattr(cli, entry)(argv)
    assert not any(tmp_path.iterdir())
