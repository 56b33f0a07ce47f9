"""The unconditional DDPM trainer against the JAX package's: one train
step's loss and every gradient (JAX's noise, timesteps and dropout masks
injected), both scripts end to end (per-step losses within rel 1e-4, the
EMA weights they write), ``--resume``, the EMA sampler, and the flags the
port's entry point refuses because the JAX script never reads them."""

import importlib.util
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.models.punetg import PUNetGCFD as JaxPUNetG
from cfdbench_tpu.ops import diffusion as jax_ops
from cfdbench_tpu.training.checkpoints import load_params as jax_load_params
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.ops.diffusion import make_ddpm_scheduler
from cfdbench_tpu_torch.training import trainer_uncond
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from cfdbench_tpu_torch.utils.rng import uncond_key
from tests.test_torch_diffusion import (
    SAMPLE_RTOL,
    assert_grads_close,
    four_groups,
    inject_jax_draws,
    jax_dropout_masks,
    jax_key,
    named_grads,
    t,
)
from tests.test_torch_multistep import REPO
from tests.test_torch_train import assert_close_rel, port_tree  # noqa: F401  (a fixture)

torch.set_num_threads(1)

BASE, T = 8, 10


def jax_unet():
    return JaxPUNetG(in_channels=2, out_channels=2, base_channels=BASE, n_case_params=1)


def jax_uncond_noise_and_t(key, shape, num_train_timesteps, device):
    """``trainer_uncond.py:87-95``: the step key split in three, the noise
    from the first, the timesteps from the second."""
    nkey, tkey, _ = jax.random.split(jax_key(key), 3)
    noise = jax.random.normal(nkey, tuple(shape), jnp.float32)
    steps = jax.random.randint(tkey, (shape[0],), 0, num_train_timesteps)
    return t(noise).to(device), torch.from_numpy(np.asarray(steps).astype(np.int64)).to(device)


def inject_uncond_draws(monkeypatch):
    monkeypatch.setattr(trainer_uncond, "train_noise_and_t", jax_uncond_noise_and_t)
    monkeypatch.setattr(trainer_uncond, "dropout_keep_masks", jax_dropout_masks(
        jax_unet(), n_case_params=1,
        dropout_key=lambda key: jax.random.split(jax_key(key), 3)[2]))


def test_uncond_step_matches_jax(rng, monkeypatch):
    """The loss of ``train_uncond_ddpm``'s step (``trainer_uncond.py:92-106``,
    written out here as the JAX trainer computes it, dropout on), a padded
    last row weighted out: within rel 1e-5; every gradient within 1e-5 of
    its max (four groups a GroupNorm)."""
    four_groups(monkeypatch)
    inject_uncond_draws(monkeypatch)
    unet = trainer_uncond.make_unet(2, BASE, 0, "cpu")
    params = params_to_flax(unet.state_dict())
    x = rng.standard_normal((3, 16, 16, 2)).astype(np.float32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    key = uncond_key(4, 6)
    scheduler, js = make_ddpm_scheduler(T), jax_ops.make_ddpm_scheduler(T)

    def jax_loss(p, rng_key):
        nkey, tkey, dkey = jax.random.split(rng_key, 3)
        noise = jax.random.normal(nkey, x.shape, x.dtype)
        steps = jax.random.randint(tkey, (x.shape[0],), 0, T)
        eps = jax_unet().apply({"params": p}, js.add_noise(x, noise, steps), steps,
                               jnp.zeros((x.shape[0], 1)), train=True, rngs={"dropout": dkey})
        per = jnp.mean(jnp.square(eps - noise), axis=(1, 2, 3))
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)

    want, grads = jax.jit(jax.value_and_grad(jax_loss))(params, jax_key(key))
    loss = trainer_uncond.step_loss(unet, scheduler, t(x), t(w), key)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert_grads_close(named_grads(unet), grads)


def test_ema_update_is_a_copy_moved_by_its_decay():
    ema = [torch.ones(3), torch.zeros(2)]
    params = [torch.full((3,), 3.0), torch.ones(2)]
    trainer_uncond.ema_update(ema, params, 0.75)
    torch.testing.assert_close(ema, [torch.full((3,), 1.5), torch.full((2,), 0.25)])
    assert params[0][0] == 3.0


def uncond_argv(data_root, out, epochs=2, lr="1e-3"):
    return ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(out), "--num_epochs", str(epochs), "--batch_size", "16",
            "--lr", lr, "--pixel_diffusion_base_channels", str(BASE),
            "--ldm_noise_scheduler_timesteps", str(T), "--mesh_shape", "1", "--seed", "3"]


def jax_script(argv, monkeypatch):
    """``train_diffusion_uncond.py``'s ``main`` on ``argv``."""
    spec = importlib.util.spec_from_file_location("train_diffusion_uncond",
                                                  REPO / "train_diffusion_uncond.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["train_diffusion_uncond.py"] + argv)
    script.main()


def test_main_uncond_matches_the_jax_script(port_tree, tmp_path, monkeypatch):
    """Both scripts, 2 epochs from the port's init (handed to the JAX
    network) with JAX's draws: the files, the per-step losses within rel
    1e-4, and the EMA weights each writes to ``ema_model/``, each element
    within one float32 rounding a step of the EMA's recurrence (its
    movement at decay 0.9999 is barely more) plus 1e-3 of its tensor's
    movement from the initial weights (all of a zero-initialised bias's
    EMA). At lr 1e-5, as ``test_torch_family_cli.py`` runs the U-Net:
    Adam's normalisation turns an element's near-zero gradient into ±lr
    steps that differ between the packages, and the EMA follows them. No frame is sampled (every 10 epochs). Four groups a
    GroupNorm: with one channel a group, biases whose gradient is 0 in
    exact arithmetic take Adam's ±lr steps on rounding noise, differently in
    each package, and the EMA follows them."""
    four_groups(monkeypatch)
    unet = trainer_uncond.make_unet(2, BASE, 3, "cpu")
    params = params_to_flax(unet.state_dict())
    with monkeypatch.context() as mp:
        mp.setattr(JaxPUNetG, "init", lambda self, *a, **k: {"params": params})
        jax_script(uncond_argv(port_tree, tmp_path / "jax", lr="1e-5"), mp)
    inject_uncond_draws(monkeypatch)
    _, ema, losses = cli.main_uncond(uncond_argv(port_tree, tmp_path / "port", lr="1e-5"),
                                     device="cpu")
    runs = [tmp_path / pkg / "uncond_ddpm" / "cavity_prop_bc_geo" for pkg in ("jax", "port")]
    for name in ("train_losses.json", "training_meta.json"):
        assert all((r / name).exists() for r in runs), name
    assert (runs[1] / "ema_model" / "model.pt").exists()
    assert (runs[1] / "training_state" / "model.pt").exists()
    want = json.loads((runs[0] / "train_losses.json").read_text())
    assert len(want) > 2 and losses == json.loads((runs[1] / "train_losses.json").read_text())
    assert_close_rel(losses, want, "uncond losses")
    want_ema = params_from_flax(
        jax_load_params({"params": params}, runs[0] / "ema_model")["params"])
    got_ema = torch.load(runs[1] / "ema_model" / "model.pt", weights_only=True)
    torch.testing.assert_close(got_ema, ema.state_dict(), rtol=0, atol=0)
    start = unet.state_dict()
    for k, w in want_ema.items():
        moved = (w - start[k]).abs().max().item()
        np.testing.assert_allclose(got_ema[k].numpy(), w.numpy(), rtol=len(losses) * 2.0**-23,
                                   atol=1e-3 * moved, err_msg=k)


def test_main_uncond_resume_continues_as_one_run(port_tree, tmp_path):
    """One epoch, then ``--resume 1`` for a second: the losses, weights, EMA
    and optimizer of a straight two-epoch run, bit for bit."""
    straight = cli.main_uncond(uncond_argv(port_tree, tmp_path / "a"), device="cpu")
    cli.main_uncond(uncond_argv(port_tree, tmp_path / "b", epochs=1), device="cpu")
    resumed = cli.main_uncond(uncond_argv(port_tree, tmp_path / "b") + ["--resume", "1"],
                              device="cpu")
    assert straight[2] == resumed[2]
    for got, want in zip(resumed[:2], straight[:2]):
        torch.testing.assert_close(got.state_dict(), want.state_dict(), rtol=0, atol=0)


def test_sample_grid_matches_jax(monkeypatch, tmp_path):
    """4 frames from the EMA network with the evaluation key (JAX's
    ``PRNGKey(0)``) and JAX's sampler noise, 3 steps; the png is written."""
    inject_jax_draws(monkeypatch)
    unet = trainer_uncond.make_unet(2, BASE, 1, "cpu").eval()
    params = params_to_flax(unet.state_dict())
    shape = (4, 16, 16, 2)
    got = trainer_uncond.sample_grid(unet, make_ddpm_scheduler(T), shape, tmp_path / "s.png",
                                     num_inference_steps=3).numpy()

    def denoise(x, steps):
        return jax_unet().apply({"params": params}, x, steps, jnp.zeros((x.shape[0], 1)))

    want = np.asarray(jax_ops.ddpm_sample(jax_ops.make_ddpm_scheduler(T), denoise, shape,
                                          jax.random.PRNGKey(0), 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_RTOL * np.abs(want).max())
    assert (tmp_path / "s.png").exists()


@pytest.mark.parametrize("flags", [
    ["--pixel_diffusion_channel_mults", "1", "2"], ["--pixel_diffusion_dropout", "0"],
    ["--use_mixed_precision"], ["--mode", "train_test"], ["--weight_decay", "0.1"],
])
def test_main_uncond_refuses_what_the_jax_script_ignores(port_tree, tmp_path, flags):
    with pytest.raises(NotImplementedError, match="train_diffusion_uncond.py ignores it "
                                                  ".ROADMAP.md C"):
        cli.main_uncond(uncond_argv(port_tree, tmp_path) + flags, device="cpu")
    assert not any(tmp_path.iterdir())


def test_main_uncond_needs_a_card(port_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        cli.main_uncond(uncond_argv(port_tree, tmp_path))
    assert not any(tmp_path.iterdir())
