"""The port's latent diffusion pieces against the JAX package: the PUNetG's
cross-attention block (and the head count its JAX docstring misstates,
ROADMAP.md C), each latent model's loss and every gradient at 18x17 (a
non-square grid padded to 24x24) with JAX's draws injected (the frozen
VAE's posterior sample, the noise and the timesteps), each model's
``predict_frame`` with JAX's sampler noise, the padded field and the latent
shape at 66x65, and the frozen VAE kept out of the trainable networks.

The weights are the port's init carried across by ``flax_import``; the
PUNetG runs at four groups a GroupNorm, as in ``test_torch_diffusion.py``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models import diffusion as jax_diffusion
from cfdbench_tpu.models.punetg import CrossAttnBlock as JaxCrossAttnBlock
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.metrics import loss_name_to_fn
from cfdbench_tpu_torch.models import diffusion, init_latent_diffusion, make_cfd_vae
from cfdbench_tpu_torch.models.punetg import CrossAttnBlock
from cfdbench_tpu_torch.training import trainer_auto
from cfdbench_tpu_torch.training.optim import make_adam
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from cfdbench_tpu_torch.utils.rng import train_key
from tests.test_torch_diffusion import (
    ATOL,
    SAMPLE_RTOL,
    assert_grads_close,
    four_groups,
    inject_jax_draws,
    jax_key,
    named_grads,
    t,
    task_batch,
)
from tests.test_torch_vae import inject_posterior_noise

torch.set_num_threads(1)

CLASSES = {
    "v1": (diffusion.LatentDiffusionCfdModel, jax_diffusion.LatentDiffusionCfdModel),
    "v2": (diffusion.LatentDiffusionCfdModel2, jax_diffusion.LatentDiffusionCfdModel2),
    "lite": (diffusion.LatentDiffusionCfdModelLite, jax_diffusion.LatentDiffusionCfdModelLite),
}
# A narrow latent UNet, as task keywords of both packages.
SMALL = dict(unet_base_channels=8, unet_channel_mult=(1, 2), unet_num_res_blocks=1,
             noise_scheduler_timesteps=20)


def port_vae():
    return make_cfd_vae("lite", generator=torch.Generator().manual_seed(5))


def both_tasks(name):
    """The port's task (a seeded init, a random lite VAE) and the JAX task
    with the same VAE and network weights (as flax params)."""
    port_cls, jax_cls = CLASSES[name]
    vae = port_vae()
    port = port_cls(loss_name_to_fn("nmse"), vae, generator=torch.Generator().manual_seed(0),
                    **SMALL)
    jax_task = jax_cls(jax_loss_name_to_fn("nmse"), params_to_flax(vae.state_dict()), **SMALL)
    return port, jax_task, params_to_flax(port.model.state_dict())


def attn_params(block):
    params = {"GroupNorm_0": {"scale": block.group_norm.weight.detach().numpy().copy(),
                              "bias": block.group_norm.bias.detach().numpy().copy()}}
    for i, layer in enumerate((block.to_q, block.to_k, block.to_v, block.to_out)):
        params[f"Dense_{i}"] = {"Dense_0": {"kernel": layer.weight.detach().numpy().T.copy(),
                                            "bias": layer.bias.detach().numpy().copy()}}
    return params


def test_cross_attn_block_matches_jax_with_heads_of_8(rng):
    """``max(1, C // 8)`` heads of 8 dims, as the JAX code has it: at C = 64
    that is 8 heads, not the '4 heads of C/4 dims' of the JAX
    ``LatentDiffusionCfdModel2`` docstring (ROADMAP.md C). Forward and
    gradients against JAX; JAX's own output against a numpy attention of 8
    heads, and away from one of 4."""
    C, D = 64, 7
    block = CrossAttnBlock(C, D, generator=torch.Generator().manual_seed(2))
    assert block.heads == 8
    x = rng.standard_normal((2, 3, 2, C)).astype(np.float32)
    ctx = rng.standard_normal((2, 11, D)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    params = attn_params(block)

    def jax_loss(p):
        out = JaxCrossAttnBlock().apply({"params": p}, x, ctx)
        return jnp.sum(out * w), out

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    out = block(t(x), t(ctx))
    (out * t(w)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=ATOL * np.abs(want).max())
    for i, layer in enumerate((block.to_q, block.to_k, block.to_v, block.to_out)):
        for name, g in (("weight", grads[f"Dense_{i}"]["Dense_0"]["kernel"].T),
                        ("bias", grads[f"Dense_{i}"]["Dense_0"]["bias"])):
            g = np.asarray(g)
            if i == 1 and name == "bias":  # softmax cancels k's bias: 0 in exact arithmetic
                assert np.abs(g).max() < 1e-5 and getattr(layer, name).grad.abs().max() < 1e-5
                continue
            np.testing.assert_allclose(getattr(layer, name).grad.numpy(), g, rtol=0,
                                       atol=1e-5 * np.abs(g).max())

    def numpy_attention(heads):
        with torch.no_grad():
            h = block.group_norm(t(x)).numpy().reshape(2, 6, C)
            q, k, v = (f(a).numpy() for f, a in ((block.to_q, t(h)), (block.to_k, t(ctx)),
                                                  (block.to_v, t(ctx))))
        hd = C // heads
        q, k, v = (a.reshape(2, -1, heads, hd) for a in (q, k, v))
        logits = np.einsum("bqnd,bknd->bnqk", q, k) / np.sqrt(hd)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        o = np.einsum("bnqk,bknd->bqnd", p, v).reshape(2, 6, C)
        with torch.no_grad():
            return x + block.to_out(t(o)).numpy().reshape(x.shape)

    scale = np.abs(want).max()
    assert np.abs(numpy_attention(8) - want).max() < 1e-5 * scale
    assert np.abs(numpy_attention(4) - want).max() > 1e-3 * scale


@pytest.mark.parametrize("name", list(CLASSES))
def test_latent_loss_matches_jax(rng, monkeypatch, name):
    """``loss_scores`` of a train step at 18x17 with JAX's draws injected:
    every score within rel 1e-5, every gradient within 1e-5 of its max (of
    the largest where it is 0 in exact arithmetic: softmax cancels the
    cross-attention's k bias)."""
    four_groups(monkeypatch)
    port, jax_task, params = both_tasks(name)
    inject_jax_draws(monkeypatch)
    inject_posterior_noise(monkeypatch)
    host = task_batch(rng, H=18, W=17)
    key = train_key(7, 3)

    def jax_loss(p, rng_key):
        return jax_task.loss_scores(p, host, train=True, rng=rng_key)

    (_, (want, _)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params, jax_key(key))

    def port_loss(task, dtype):
        loss, scores = task.loss_scores({k: t(v).to(dtype) for k, v in host.items()}, key)
        loss.backward()
        return scores

    exact = copy.deepcopy(port)
    exact.model.double()
    exact.vae.double()
    port_loss(exact, torch.float64)
    got = port_loss(port, torch.float32)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-5, err_msg=k)
    assert_grads_close(named_grads(port.model), grads, named_grads(exact.model))
    assert all(p.grad is None for p in port.vae.parameters())


@pytest.mark.parametrize("name", list(CLASSES))
def test_latent_predict_frame_matches_jax(rng, monkeypatch, name):
    """A 3-step frame from the evaluation key at 18x17 with JAX's sampler
    noise: latents on the padded grid's 3x3, decoded, cropped, masked."""
    port, jax_task, params = both_tasks(name)
    inject_jax_draws(monkeypatch)
    port.num_inference_steps = jax_task.num_inference_steps = 3
    host = task_batch(rng, H=18, W=17)
    got = port.predict_frame(t(host["inputs"]), t(host["case_params"]), t(host["mask"])).numpy()
    want = np.asarray(jax_task.predict_frame(params, host["inputs"], host["case_params"],
                                             host["mask"]))
    assert got.shape == want.shape == (2, 18, 17, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("H,W", [(66, 65), (18, 17), (64, 64)])
def test_padded_field_and_latent_shape_like_jax(rng, H, W):
    """Fields zero-padded to multiples of 8; the latents' shape from the
    encoder's floor chain on the padded grid, both axes."""
    port, jax_task, _ = both_tasks("lite")
    x = rng.standard_normal((2, H, W, 2)).astype(np.float32)
    np.testing.assert_array_equal(diffusion.pad_field(t(x)).numpy(),
                                  np.asarray(jax_task._pad_field(x)))
    assert port.vae.latent_shape(diffusion.pad_field(t(x)).shape) == jax_task._latent_shape(x)


@pytest.mark.parametrize("model", ["latent_diffusion", "latent_diffusion2",
                                   "latent_diffusion_lite", "latent_diffusion2_lite"])
def test_frozen_vae_is_no_part_of_the_trained_networks(rng, model):
    """The task's trainable networks hold the JAX params tree's nests (and
    carry to it and back exactly) and nothing of the VAE: not in ``state_dict()`` (so not in ``model.pt``),
    not in the optimizer; a train step leaves the VAE as it was.
    ``latent_diffusion2_lite`` is the Lite class."""
    args = Args.parse_args(["--model", model, "--unet_base_channels", "8",
                            "--unet_channel_mult", "1", "2"])
    vae_state = port_vae().state_dict()
    task = init_latent_diffusion(args, 5, vae_state, loss_name_to_fn("nmse"))
    nests = {"latent_diffusion": {"context_proj", "unet"}, "latent_diffusion2": {"unet"},
             "latent_diffusion_lite": {"cond_encoder", "unet"},
             "latent_diffusion2_lite": {"cond_encoder", "unet"}}[model]
    sd = task.model.state_dict()
    assert set(params_to_flax(sd)) == nests
    assert {k.split(".")[0] for k in sd} == nests
    torch.testing.assert_close(params_from_flax(params_to_flax(sd)), sd, rtol=0, atol=0)
    vae_ids = {id(p) for p in task.vae.parameters()}
    opt, sched = make_adam(task.model.parameters(), 1e-3)
    assert not vae_ids & {id(p) for g in opt.param_groups for p in g["params"]}
    batch = {k: t(v) for k, v in task_batch(rng).items()}
    trainer_auto.train_step(task, opt, sched, batch, train_key(0, 0))
    torch.testing.assert_close(task.vae.state_dict(), vae_state, rtol=0, atol=0)
