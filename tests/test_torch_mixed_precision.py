"""``--use_mixed_precision`` in the port against the JAX package: the
bfloat16 train step of the FNO, the U-Net, the FFNO, an Auto-DeepONet,
pixel diffusion, GenCast and a latent model (the Lite) from the same
float32 weights and batch, its loss, scores, train-forward output and
gradients; the float32 master weights, optimizer and evaluation; and
both entry points, ``main_auto`` and ``main_gencast``, with the flag.

Each bound is stated beside its test, at most 4x the largest error
measured here on the CPU. Each test also shows that bfloat16 ran: an
activation inside the port's model is ``torch.bfloat16`` (a forward
hook), and the port's bfloat16 output is off its own float32 output by
more than 1e-3 of its max.

bfloat16 sums: XLA on the CPU reduces a bfloat16 cotangent (a bias's
gradient) in bfloat16, torch accumulates it in float32, so the gradients
are held to a share of the model's largest gradient, not each its own."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.config import Args as JaxArgs
from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models import init_auto_model as jax_init_auto_model
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.metrics import loss_name_to_fn
from cfdbench_tpu_torch.models import init_auto_model
from cfdbench_tpu_torch.training import trainer_auto
from cfdbench_tpu_torch.utils.flax_import import batch_stats_to_flax, params_to_flax
from tests.test_torch_diffusion import both_tasks as diffusion_tasks
from tests.test_torch_diffusion import four_groups, inject_jax_draws, jax_key, task_batch
from tests.test_torch_generative_cli import gen_argv, run_of
from tests.test_torch_ldm import both_tasks as latent_tasks
from tests.test_torch_train import port_tree  # noqa: F401  (a fixture)
from tests.test_torch_train import run_dir, train_argv
from tests.test_torch_vae import inject_posterior_noise

torch.set_num_threads(1)

BF16 = torch.bfloat16
# The port's own bfloat16 output must be this far (of its max) from its
# float32 output, or the test compared float32 with float32.
SEPARATION = 1e-3

FLAGS = {
    "fno": ["--model", "fno", "--fno_hidden_dim", "8", "--fno_depth", "2",
            "--fno_modes_x", "4", "--fno_modes_y", "4"],
    "unet": ["--model", "unet", "--unet_dim", "4"],
    "ffno": ["--model", "ffno", "--fno_hidden_dim", "8", "--fno_depth", "2",
             "--fno_modes_x", "4", "--fno_modes_y", "4"],
    "auto_deeponet": ["--model", "auto_deeponet", "--deeponet_width", "16",
                      "--branch_depth", "2", "--trunk_depth", "2"],
}
# Bounds on JAX vs the port, each in bfloat16, per model: the train
# forward's output (of its max), the loss and scores (relative), the
# gradients (of the largest). Measured on the CPU against the jitted JAX
# step: the FNO 1.53e-2, 6.1e-5, 3.5e-3; the U-Net 1.69e-2, 3.7e-4 (its
# gradients: see the test); the FFNO 3.5e-3, 2.1e-5, 1.07e-2; the
# Auto-DeepONet 6.0e-4, 1.2e-4, 7.6e-3. Each bound is under 4x its
# measurement, and none above 5e-2.
TOLS = {
    "fno": (5e-2, 2.4e-4, 1.4e-2),
    "unet": (5e-2, 1.4e-3, None),
    "ffno": (1.4e-2, 8e-5, 4e-2),
    "auto_deeponet": (2.4e-3, 4.8e-4, 3e-2),
}


def seeded_batch(B=4, H=16, W=16):
    rng = np.random.default_rng(0)
    batch = dict(inputs=rng.standard_normal((B, H, W, 2)),
                 labels=rng.standard_normal((B, H, W, 2)),
                 mask=rng.uniform(size=(B, H, W, 1)) > 0.2,
                 case_params=rng.standard_normal((B, 5)),
                 weights=np.ones(B))
    return {k: np.asarray(v, np.float32) for k, v in batch.items()}


def jax_step(name, sd, batch, compute_dtype):
    """JAX's train forward, loss and gradients under ``compute_dtype``."""
    params, stats = params_to_flax(sd), batch_stats_to_flax(sd)
    task = JaxAutoTask(jax_init_auto_model(JaxArgs.parse_args(FLAGS[name]), n_case_params=5,
                                           field_shape=batch["inputs"].shape[1:3]),
                       jax_loss_name_to_fn("nmse"), compute_dtype=compute_dtype)
    state = {"batch_stats": stats} if stats else {}

    def loss(p):
        return task.loss_scores(p, batch, model_state=state, train=True)

    (value, (scores, new_state)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    preds = jax.jit(lambda p: task._forward(p, state, batch, True, None)[0])(params)
    return np.asarray(preds, np.float32), float(value), scores, grads, new_state


def port_step(name, sd, batch, compute_dtype):
    """The port's train step under ``compute_dtype``: ``(output, loss,
    scores, gradients, model, dtypes)``, the dtypes of every module's
    output."""
    model = init_auto_model(Args.parse_args(FLAGS[name]), n_case_params=5,
                            field_shape=batch["inputs"].shape[1:3])
    model.load_state_dict(sd)
    model.train()
    task = trainer_auto.AutoTask(model, loss_name_to_fn("nmse"), compute_dtype=compute_dtype)
    dtypes, outs = [], []
    hooks = [m.register_forward_hook(lambda m, i, o: dtypes.append(o.dtype)) for m in model.modules()]
    hooks.append(model.register_forward_hook(lambda m, i, o: outs.append(o)))
    loss, scores = task.loss_scores({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    for h in hooks:
        h.remove()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return outs[0].detach().float().numpy(), loss.item(), scores, grads, model, dtypes


def leaves(tree):
    return [np.asarray(g) for _, g in sorted(jax.tree_util.tree_leaves_with_path(tree),
                                             key=lambda kv: jax.tree_util.keystr(kv[0]))]


def max_grad_error(got, want):
    """The largest difference of two gradient trees over want's largest."""
    got, want = leaves(got), leaves(want)
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / max(
        np.abs(w).max() for w in want)


@pytest.fixture(scope="module")
def batch():
    return seeded_batch()


@pytest.mark.parametrize("name", list(FLAGS))
def test_mixed_precision_train_step_matches_jax(batch, name):
    """The bfloat16 train step from the same float32 weights at the bounds
    of ``TOLS``: the forward's output, the loss and every score, the
    gradients (the U-Net's: see below). The gradients are float32, on the
    float32 weights, and the model ran in bfloat16 (a module's output is
    bfloat16, and the output is off the float32 one)."""
    out_tol, loss_rtol, grad_tol = TOLS[name]
    sd = init_auto_model(Args.parse_args(FLAGS[name]), n_case_params=5,
                         field_shape=(16, 16)).state_dict()
    want_out, want_loss, want_scores, want_grads, want_state = jax_step(name, sd, batch,
                                                                         jnp.bfloat16)
    out, loss, scores, grads, model, dtypes = port_step(name, sd, batch, BF16)
    out32 = port_step(name, sd, batch, None)[0]

    assert BF16 in dtypes
    assert all(p.dtype == torch.float32 and g.dtype == torch.float32
               for p, g in zip(model.parameters(), grads.values()))
    scale = np.abs(want_out).max()
    assert np.abs(out - out32).max() > SEPARATION * np.abs(out32).max()
    np.testing.assert_allclose(out, want_out, rtol=0, atol=out_tol * scale)
    assert loss == pytest.approx(want_loss, rel=loss_rtol)
    for k, v in want_scores.items():
        assert scores[k].item() == pytest.approx(float(v), rel=loss_rtol), k
    got_grads = params_to_flax(grads)
    if name != "unet":
        assert max_grad_error(got_grads, want_grads) <= grad_tol
        return
    # The U-Net's bfloat16 gradient at this size is rounding: its eight
    # BatchNorms see as few as B x 1 x 1 values and cancel most of it, and
    # JAX's own bfloat16 gradient is 0.54 (L2) from its float32 one,
    # farther than the 5e-2 that a bound may reach (ROADMAP.md C). What is
    # held: the float32 running statistics that the step leaves (measured
    # 1.63e-2 of each one's max; bound 5e-2), and the gradient of the
    # output conv's kernel, after the last BatchNorm (measured 2.3e-3 of
    # its max; bound 9e-3).
    for got, want in zip(leaves(batch_stats_to_flax(model.state_dict())),
                         leaves(want_state["batch_stats"])):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max())
    g = got_grads["Conv_0"]["Conv_0"]["kernel"]
    w = np.asarray(want_grads["Conv_0"]["Conv_0"]["kernel"])
    assert np.abs(g - w).max() <= 9e-3 * np.abs(w).max()


# --- the diffusion tasks --------------------------------------------------

def diffusion_pair(name, monkeypatch):
    """The port's task, the JAX one and its params, both in bfloat16
    compute, with JAX's draws in the port (noise, timesteps, dropout masks,
    the VAE's posterior sample)."""
    four_groups(monkeypatch)
    if name == "latent_lite":
        port, jax_task, params = latent_tasks("lite")
        inject_jax_draws(monkeypatch)
        inject_posterior_noise(monkeypatch)
    else:
        port, jax_task, params = diffusion_tasks(name)
        inject_jax_draws(monkeypatch, jax_task.unet)
    return port, jax_task, params


def diffusion_step(port, host, key, compute_dtype):
    """``(scores, gradients, eps, dtypes)`` of the port's train loss; eps and
    the dtypes from forward hooks on its UNet."""
    unet = getattr(port.model, "unet", port.model)
    port.compute_dtype = compute_dtype
    port.model.zero_grad()
    dtypes, outs = [], []
    hooks = [m.register_forward_hook(lambda m, i, o: dtypes.append(o.dtype)) for m in unet.modules()]
    hooks.append(unet.register_forward_hook(lambda m, i, o: outs.append(o)))
    loss, scores = port.loss_scores({k: torch.from_numpy(v) for k, v in host.items()}, key)
    loss.backward()
    for h in hooks:
        h.remove()
    grads = {k: p.grad.clone() for k, p in port.model.named_parameters()}
    return scores, grads, outs[0].detach().float().numpy(), dtypes


# Measured on the CPU, JAX vs the port in bfloat16: the scores rel 1.29e-4
# (pixel), 1.50e-4 (GenCast), 1.49e-4 (Lite); the gradients 6.2e-3,
# 7.0e-3, 2.7e-3 of the largest. Bounds: under 4x.
DIFFUSION_TOLS = {"pixel": (5e-4, 2.4e-2), "gencast": (6e-4, 2.8e-2),
                  "latent_lite": (5e-4, 1e-2)}


@pytest.mark.parametrize("name", list(DIFFUSION_TOLS))
def test_mixed_precision_diffusion_loss_matches_jax(rng, monkeypatch, name):
    """A train step's loss (its train key, dropout on for pixel diffusion
    and GenCast) in bfloat16 with JAX's draws: every score and the
    gradients at the bounds of ``DIFFUSION_TOLS``. The UNet's first conv
    returns bfloat16, its noise prediction is off the float32 one, and
    the Lite's frozen VAE and CondEncoder stay float32."""
    from cfdbench_tpu_torch.utils.rng import train_key

    score_rtol, grad_tol = DIFFUSION_TOLS[name]
    port, jax_task, params = diffusion_pair(name, monkeypatch)
    jax_task.compute_dtype = jnp.bfloat16
    host = task_batch(rng, gencast=name == "gencast") if name != "latent_lite" else \
        task_batch(rng, H=18, W=17)
    key = train_key(7, 3)

    def jax_loss(p, rng_key):
        return jax_task.loss_scores(p, host, train=True, rng=rng_key)

    (_, (want, _)), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params, jax_key(key))
    scores, grads, eps, dtypes = diffusion_step(port, host, key, BF16)
    eps32 = diffusion_step(port, host, key, None)[2]
    assert BF16 in dtypes
    assert np.abs(eps - eps32).max() > SEPARATION * np.abs(eps32).max()
    for k, v in want.items():
        assert scores[k].item() == pytest.approx(float(v), rel=score_rtol), k
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert max_grad_error(params_to_flax(grads), want_grads) <= grad_tol
    if name == "latent_lite":
        assert all(p.dtype == torch.float32 and p.grad is None for p in port.vae.parameters())


# --- the entry points -----------------------------------------------------

def spy_on_cast_call(monkeypatch, module):
    """Replace ``module.cast_call`` by one that records, for each call, its
    dtype, its first input's dtype and how far its output lies from the
    same call in float32 (over the latter's max)."""
    real = module.cast_call
    seen = []

    def spy(net, dtype, *args, **kwargs):
        out = real(net, dtype, *args, **kwargs)
        with torch.no_grad():
            ref = real(net, None, *(a.float() if torch.is_tensor(a) and a.is_floating_point()
                                    else a for a in args), **kwargs)
        seen.append((dtype, args[0].dtype,
                     ((out.float() - ref).abs().max() / ref.abs().max()).item()))
        return out

    monkeypatch.setattr(module, "cast_call", spy)
    return seen


def assert_ran_bf16(seen):
    assert seen and all(d == BF16 and x == BF16 for d, x, _ in seen)
    assert max(gap for _, _, gap in seen) > SEPARATION

def test_main_auto_mixed_precision_matches_jax_end_to_end(port_tree, tmp_path, monkeypatch):
    """``main_auto --use_mixed_precision 1 --mode train_test`` for the FNO,
    2 epochs, from the JAX trainer's initial weights, against the JAX
    main_auto with the flag: the per-step train losses (measured 1.52e-4
    relative; bound 6e-4), the dev losses (4.7e-7; 1.8e-6), the test
    scores (4.2e-6; 1.6e-5) and the test predictions, float32 evaluation
    of the bfloat16-trained weights (2.4e-3 of their max; 9e-3). The
    checkpoints hold float32 weights."""
    from cfdbench_tpu.cli import main_auto as jax_main_auto
    from cfdbench_tpu_torch.utils.flax_import import params_from_flax
    from tests.test_torch_multistep import jax_params

    argv = train_argv(port_tree, 2) + ["--mode", "train_test", "--use_mixed_precision", "1"]
    jax_main_auto(argv + ["--output_dir", str(tmp_path / "jax")])
    start = params_from_flax(jax.device_get(jax_params()))

    def init_from_jax(*args, **kwargs):
        model = init_auto_model(*args, **kwargs)
        model.load_state_dict(start)
        return model

    monkeypatch.setattr(cli, "init_auto_model", init_from_jax)
    seen = spy_on_cast_call(monkeypatch, trainer_auto)
    cli.main_auto(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")
    assert_ran_bf16(seen)
    want_run, got_run = run_dir(tmp_path / "jax"), run_dir(tmp_path / "port")

    def load(run, name):
        return json.loads((run / name).read_text())

    def close(got, want, rtol):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=rtol)

    close(load(got_run, "train_losses.json"), load(want_run, "train_losses.json"), 6e-4)
    for ep in (0, 1):
        close(load(got_run, f"ckpt-{ep}/scores.json")["dev_loss"],
              load(want_run, f"ckpt-{ep}/scores.json")["dev_loss"], 1.8e-6)
    close(list(load(got_run, "test/scores.json")["mean"].values()),
          list(load(want_run, "test/scores.json")["mean"].values()), 1.6e-5)
    want = np.load(want_run / "test/preds.npy")
    np.testing.assert_allclose(np.load(got_run / "test/preds.npy"), want, rtol=0,
                               atol=9e-3 * np.abs(want).max())
    assert all(v.dtype == torch.float32 for v in
               torch.load(got_run / "ckpt-1" / "model.pt", weights_only=True).values())
    moments = torch.load(got_run / "training_state" / "model.pt",
                         weights_only=True)["optimizer"]["state"].values()
    assert moments and all(m[k].dtype == torch.float32 for m in moments
                           for k in ("exp_avg", "exp_avg_sq"))


def test_evaluation_and_rollout_stay_float32(batch):
    """A task with the bfloat16 compute dtype evaluates and predicts in
    float32, exactly as without it; its train forward alone is bfloat16."""
    model = init_auto_model(Args.parse_args(FLAGS["fno"]), n_case_params=5, field_shape=(16, 16))
    mixed = trainer_auto.AutoTask(model, loss_name_to_fn("nmse"), compute_dtype=BF16)
    plain = trainer_auto.AutoTask(model, loss_name_to_fn("nmse"))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = trainer_auto.eval_step(mixed, b)
    want = trainer_auto.eval_step(plain, b)
    assert got[2].dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    frame = mixed.predict_frame(b["inputs"], b["case_params"], b["mask"])
    torch.testing.assert_close(frame, plain.predict_frame(b["inputs"], b["case_params"],
                                                          b["mask"]), rtol=0, atol=0)


def test_bf16_fno_runs_no_kernel_wrapper(batch, monkeypatch):
    """The FNO's bfloat16 train forward takes the plain versions, chosen by
    its dtype: the kernel wrappers, which raise on a bfloat16 CUDA tensor,
    are never called; the float32 forward calls each once a block and once
    for the head."""
    from cfdbench_tpu_torch.models import fno

    calls = []
    for name in ("fno_block", "fno_head"):
        wrapped = getattr(fno, name)
        monkeypatch.setattr(fno, name, lambda *a, _w=wrapped, _n=name: calls.append(_n) or _w(*a))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = init_auto_model(Args.parse_args(FLAGS["fno"]), n_case_params=5, field_shape=(16, 16))
    outs = []
    model.register_forward_hook(lambda m, i, o: outs.append(o.detach()))
    trainer_auto.AutoTask(model, loss_name_to_fn("nmse"), compute_dtype=BF16).loss_scores(b)
    assert calls == []
    trainer_auto.AutoTask(model, loss_name_to_fn("nmse")).loss_scores(b)
    assert calls == ["fno_block", "fno_block", "fno_head"]
    assert [o.dtype for o in outs] == [BF16, torch.float32]
    assert (outs[0].float() - outs[1]).abs().max() > SEPARATION * outs[1].abs().max()


@pytest.mark.parametrize("model,extra", [
    ("fno", []),
    ("pixel_diffusion", ["--pixel_diffusion_base_channels", "8",
                         "--pixel_diffusion_channel_mults", "1", "2",
                         "--pixel_diffusion_num_res_blocks", "1"]),
])
def test_make_auto_task_takes_the_compute_dtype(port_tree, model, extra):
    args = Args.parse_args(["--model", model, "--data_dir", str(port_tree)] + extra)
    assert cli.make_auto_task(args, 5, (16, 16), "cpu").compute_dtype is None
    args.use_mixed_precision = True
    assert cli.make_auto_task(args, 5, (16, 16), "cpu").compute_dtype == BF16


def test_main_gencast_mixed_precision_trains(port_tree, tmp_path, monkeypatch):
    """``main_gencast --use_mixed_precision 1 --mode train_test``: its train
    steps run the PUNetG on bfloat16 inputs and weights; finite test
    scores, float32 weights in the saved state."""
    from cfdbench_tpu_torch.models import diffusion

    argv = gen_argv("gencast", port_tree, 1, tmp_path) + ["--mode", "train_test",
                                                            "--use_mixed_precision", "1"]
    seen = spy_on_cast_call(monkeypatch, diffusion)
    cli.main_gencast(argv, device="cpu")
    assert_ran_bf16([s for s in seen if s[0] is not None])
    run = run_of(argv)
    scores = json.loads((run / "test" / "scores.json").read_text())["mean"]
    assert scores and all(np.isfinite(v) for v in scores.values())
    state = torch.load(run / "training_state" / "model.pt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in state["params"].values()
               if v.is_floating_point())
