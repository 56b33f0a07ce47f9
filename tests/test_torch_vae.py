"""The port's VAE against the JAX package: the VAE's encode (mean and
clipped log-variance), posterior sample, decode and KL, forwards within
2e-5 and gradients within 1e-5 of their max, at lite width on 16x16 and at
a small custom width; the mid block's attention; ``train_vae``'s history
(a plateau cut, an early stop, a resume that runs only the remaining
epochs) against JAX's at rel 1e-4; and ``main_vae``'s flags, with the JAX
package shown to ignore those the port refuses (ROADMAP.md C).

The weights are the port's init carried across by ``flax_import``; the
posterior's noise is JAX's own, put in place of the port's module-level
draw (``models/vae.py::posterior_noise``)."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_vae as jax_main_vae
from cfdbench_tpu.data.vae_data import VaeDataset as JaxVaeDataset
from cfdbench_tpu.models import vae as jax_vae
from cfdbench_tpu.training.trainer_vae import train_vae as jax_train_vae
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.data.vae_data import VaeDataset
from cfdbench_tpu_torch.models import vae
from cfdbench_tpu_torch.models.common import num_groups_for
from cfdbench_tpu_torch.training.trainer_vae import train_vae
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from cfdbench_tpu_torch.utils.rng import vae_key
from tests.test_torch_diffusion import ATOL, assert_grads_close, jax_key, named_grads, t
from tests.test_torch_train import assert_close_rel

torch.set_num_threads(1)

SMALL = dict(variant="custom", ch=8, ch_mult=(1, 2), num_res_blocks=2)


def jax_posterior_noise(key, shape, device):
    """The JAX package's draw for the port's posterior key."""
    return t(jax.random.normal(jax_key(key), tuple(shape), jnp.float32)).to(device)


def inject_posterior_noise(monkeypatch):
    monkeypatch.setattr(vae, "posterior_noise", jax_posterior_noise)


def both_vaes(kw):
    port = vae.make_cfd_vae(**kw, generator=torch.Generator().manual_seed(0))
    return port, jax_vae.make_cfd_vae(**kw), params_to_flax(port.state_dict())


def four_groups(monkeypatch):
    """Both packages' VAE GroupNorms at four groups, so that each holds
    several channels at a narrow width (``test_torch_diffusion.four_groups``):
    with one channel a group the norms downstream of the mid block's
    attention cancel its GroupNorm's bias gradient to a near-zero sum."""
    monkeypatch.setattr(jax_vae, "num_groups_for", lambda groups, c: num_groups_for(4, c))
    monkeypatch.setattr(vae, "num_groups_for", lambda groups, c: num_groups_for(4, c))


@pytest.mark.parametrize("kw", [dict(variant="lite"), SMALL], ids=["lite", "custom"])
def test_vae_matches_jax(rng, monkeypatch, kw):
    """The tree and its round trip; encode's mean and clipped log-variance,
    a posterior sample (JAX's noise), the decode and the KL within 2e-5 of
    their max, and every gradient of a loss over all of them within 1e-5
    of its max (of the largest gradient where it is 0 in exact arithmetic:
    at lite width the first level's GroupNorms hold one channel a group;
    the custom width runs at four groups a norm).
    The port's convolutions run without oneDNN here: at lite width its
    float32 gradients stray 1.2-1.9e-5 of their max from float64's, XLA's
    3-8e-6, the plain convolutions' 4-7e-6."""
    inject_posterior_noise(monkeypatch)
    if kw["variant"] == "custom":
        four_groups(monkeypatch)
    port, jv, params = both_vaes(kw)
    template = jax.eval_shape(jv.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 2)))
    assert (jax.tree_util.tree_structure(template["params"])
            == jax.tree_util.tree_structure(params))
    assert [a.shape for a in jax.tree.leaves(template["params"])] == [
        a.shape for a in jax.tree.leaves(params)]
    torch.testing.assert_close(params_from_flax(params), port.state_dict(), rtol=0, atol=0)
    x = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    key = vae_key(3, 5)
    wr = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)

    def jax_fwd(p):
        recon, post = jv.apply({"params": p}, x, rng=jax_key(key))
        dec = jv.apply({"params": p}, post.mean, method=jv.decode)
        outs = dict(mean=post.mean, logvar=post.logvar, recon=recon, decode=dec, kl=post.kl())
        return jnp.sum(recon * wr) + 1e-3 * jnp.sum(post.kl()), outs

    (_, want), grads = jax.jit(jax.value_and_grad(jax_fwd, has_aux=True))(params)
    def port_fwd(model, dtype):
        recon, post = model(t(x).to(dtype), key)
        dec = model.decode(post.mean)
        ((recon * t(wr).to(dtype)).sum() + 1e-3 * post.kl().sum()).backward()
        return dict(mean=post.mean, logvar=post.logvar, recon=recon, decode=dec, kl=post.kl())

    exact = copy.deepcopy(port).double()
    port_fwd(exact, torch.float64)
    with torch.backends.mkldnn.flags(enabled=False):
        got = port_fwd(port, torch.float32)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=0,
                                   atol=ATOL * np.abs(w).max(), err_msg=name)
    assert_grads_close(named_grads(port), grads, named_grads(exact))


def test_logvar_is_clipped_and_kl_summed_per_sample():
    mean = torch.zeros((2, 3, 3, 4))
    logvar = torch.tensor([-50.0, 30.0]).reshape(2, 1, 1, 1).expand(2, 3, 3, 4)
    post = vae.DiagonalGaussian(mean, logvar.clamp(*vae.LOGVAR_RANGE))
    assert post.logvar.min() == -30 and post.logvar.max() == 20
    want = jax_vae.DiagonalGaussian(jnp.asarray(mean.numpy()),
                                    jnp.clip(jnp.asarray(logvar.numpy()), -30, 20)).kl()
    np.testing.assert_allclose(post.kl().numpy(), np.asarray(want), rtol=1e-6)
    assert post.kl().shape == (2,) and torch.equal(post.mode(), mean)


def test_attn_block_matches_jax(rng):
    """The mid block's single-head attention over the H·W tokens."""
    block = vae.AttnBlock(16, generator=torch.Generator().manual_seed(1))
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    params = {"GroupNorm_0": {"scale": block.group_norm.weight.detach().numpy().copy(),
                              "bias": block.group_norm.bias.detach().numpy().copy()}}
    for i, layer in enumerate((block.to_q, block.to_k, block.to_v, block.to_out[0])):
        params[f"Dense_{i}"] = {"Dense_0": {"kernel": layer.weight.detach().numpy().T.copy(),
                                            "bias": layer.bias.detach().numpy().copy()}}

    def jax_loss(p):
        out = jax_vae.AttnBlock().apply({"params": p}, x)
        return jnp.sum(out * w), out

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    out = block(t(x))
    (out * t(w)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=ATOL * np.abs(want).max())
    for i, layer in enumerate((block.to_q, block.to_k, block.to_v, block.to_out[0])):
        g = np.asarray(grads[f"Dense_{i}"]["Dense_0"]["kernel"]).T
        np.testing.assert_allclose(layer.weight.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


# --- the trainer ------------------------------------------------------------

def frames(rng, n):
    return rng.standard_normal((n, 16, 16, 2)).astype(np.float32)


TRAIN_KW = dict(num_epochs=5, lr=1e-3, batch_size=4, kl_weight=1e-2, kl_annealing_epochs=3,
                lr_factor=0.5, lr_patience=0, early_stopping_patience=1, seed=2)


def test_train_vae_history_matches_jax(rng, tmp_path, monkeypatch):
    """No epoch after the first beats the best by the huge delta: the rate
    is cut after each (plateau > 0), the run stops after epoch 2 (patience
    > 1), with KL annealing over 3 epochs and a padded last batch. The JAX
    trainer (the port's init handed to it) and the port (JAX's posterior
    draws) agree per step and per epoch within rel 1e-4; the port's run
    cut after one epoch and resumed runs only epochs 1 and 2 and ends
    where the straight run does."""
    train, dev = frames(rng, 10), frames(rng, 6)
    port, jv, params = both_vaes(SMALL)
    kw = dict(TRAIN_KW, early_stopping_delta=1e9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vae.AutoencoderKL, "init", lambda self, *a, **k: {"params": params})
        jax_train_vae(jv, JaxVaeDataset(train), JaxVaeDataset(dev), tmp_path / "jax",
                      tmp_path / "jax_w", **kw)
    want = json.loads((tmp_path / "jax" / "loss_history.json").read_text())
    assert len(want["val_total"]) == 3

    inject_posterior_noise(monkeypatch)
    data = VaeDataset(train), VaeDataset(dev)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    best = train_vae(port, *data, tmp_path / "port", tmp_path / "port_w", device="cpu", **kw)
    got = json.loads((tmp_path / "port" / "loss_history.json").read_text())
    assert got.keys() == want.keys() and got["val_steps"] == want["val_steps"] == [3, 6, 9]
    for k in got:
        assert_close_rel(got[k], want[k], k)
    meta = json.loads((tmp_path / "port" / "training_meta.json").read_text())
    assert meta["cur_lr"] == pytest.approx(kw["lr"] * 0.25) and meta["patience"] == 2
    # The best weights are the first epoch's, and they are what was saved.
    torch.testing.assert_close(torch.load(tmp_path / "port_w" / "model.pt", weights_only=True),
                               best, rtol=0, atol=0)

    port.load_state_dict(start)
    cut = dict(kw, num_epochs=1)
    train_vae(port, *data, tmp_path / "resumed", tmp_path / "resumed_w", device="cpu", **cut)
    train_vae(port, *data, tmp_path / "resumed", tmp_path / "resumed_w", device="cpu",
              resume=True, **kw)
    again = json.loads((tmp_path / "resumed" / "loss_history.json").read_text())
    assert again == got


def test_train_vae_weight_decay_is_adamw(rng, tmp_path, monkeypatch):
    """``weight_decay`` > 0: optax's adamw and torch's AdamW, decoupled and
    scaled by lr, give the same history."""
    train, dev = frames(rng, 4), frames(rng, 4)
    port, jv, params = both_vaes(SMALL)
    kw = dict(TRAIN_KW, num_epochs=2, weight_decay=0.3, early_stopping_delta=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vae.AutoencoderKL, "init", lambda self, *a, **k: {"params": params})
        jax_train_vae(jv, JaxVaeDataset(train), JaxVaeDataset(dev), tmp_path / "jax",
                      tmp_path / "jax_w", **kw)
    inject_posterior_noise(monkeypatch)
    train_vae(port, VaeDataset(train), VaeDataset(dev), tmp_path / "port", tmp_path / "port_w",
              device="cpu", **kw)
    got, want = (json.loads((tmp_path / d / "loss_history.json").read_text())
                 for d in ("port", "jax"))
    for k in got:
        assert_close_rel(got[k], want[k], k)


# --- the entry point -----------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """A 16x16 cavity tree of 12 cases, 3 frames each (about 20 train
    frames): the VAE trains on them resized to 64x64."""
    from cfdbench_tpu_torch.data.synthetic import generate_problem

    root = tmp_path_factory.mktemp("tiny_tree")
    generate_problem(root, "cavity", cases_per_subset=4, num_frames=3, grid=16, seed=0)
    return root


def vae_argv(data_root, out):
    return ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(out / "result"), "--ldm_vae_weights_path", str(out / "w"),
            "--vae_variant", "custom", "--ch", "4", "--ch_mult", "1", "1", "1",
            "--num_res_blocks", "1", "--z_channels", "2", "--num_epochs", "1",
            "--batch_size", "64", "--mesh_shape", "1"]


def test_jax_main_vae_ignores_the_flags_the_port_refuses(tiny_tree, tmp_path):
    """The JAX main_vae with the VAE and training flags it never reads set
    writes the history it writes without them; the port refuses each."""
    ignored = {"--dropout": "0.5", "--kl_weight": "0.1", "--embed_dim": "8",
               "--resolution": "32", "--weight_decay": "0.2", "--use_mixed_precision": "1",
               "--gradient_accumulation_steps": "4", "--loss_name": "mse"}
    histories = []
    for extra in ([], [a for kv in ignored.items() for a in kv]):
        out = tmp_path / str(len(extra))
        jax_main_vae(vae_argv(tiny_tree, out) + extra)
        histories.append(json.loads(
            (out / "result" / "vae" / "cavity_prop_bc_geo" / "loss_history.json").read_text()))
    assert histories[0] == histories[1] and histories[0]["train_total"]
    for flag, value in ignored.items():
        argv = vae_argv(tiny_tree, tmp_path / "port") + [flag, value]
        with pytest.raises(NotImplementedError, match=f"{flag} .*main_vae ignores it .ROADMAP.md C"):
            cli.main_vae(argv, device="cpu")
    assert not (tmp_path / "port").exists()


def test_main_vae_trains_on_its_mode_and_needs_a_card(tiny_tree, tmp_path, monkeypatch, capsys):
    """``--mode train_anneal`` anneals (its KL weight rises per epoch in the
    log); another mode than train or train_anneal raises; without a card
    the entry point raises before writing anything."""
    with pytest.raises(ValueError, match="choose train or train_anneal"):
        cli.main_vae(vae_argv(tiny_tree, tmp_path) + ["--mode", "test"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        cli.main_vae(vae_argv(tiny_tree, tmp_path))
    assert not any(tmp_path.iterdir())
    best = cli.main_vae(vae_argv(tiny_tree, tmp_path) + [
        "--mode", "train_anneal", "--num_epochs", "2", "--vae_kl_annealing_epochs", "4"],
        device="cpu")
    run = tmp_path / "result" / "vae" / "cavity_prop_bc_geo"
    for name in ("loss_history.json", "train_loss.png", "val_loss.png", "training_meta.json",
                 "training_state/model.pt"):
        assert (run / name).exists(), name
    assert set(best) == set(torch.load(tmp_path / "w" / "model.pt", weights_only=True))
    meta = json.loads((run / "training_meta.json").read_text())
    assert meta["epoch"] == 1 and "cur_lr" in meta
    log = capsys.readouterr().out
    assert "kl_w=2.50e-05" in log and "kl_w=5.00e-05" in log
