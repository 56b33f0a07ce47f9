"""The port's FFNO against the JAX package: the 1-D spectral conv against
``spectral_conv1d_matmul`` (both axes, even and odd N, modes clamped),
``Ffno2d`` against live JAX (forwards and gradients at 16x16 and the
odd 18x17; there is no golden FFNO fixture), its parameters at the
default widths, both entry points end to end from the same weights, and
the checkpoint bridge for FFNO and non-autoregressive runs."""

import importlib.util
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_auto as jax_main_auto
from cfdbench_tpu.cli import main_multistep as jax_main_multistep
from cfdbench_tpu.config import Args as JaxArgs
from cfdbench_tpu.models import init_auto_model as jax_init_auto_model
from cfdbench_tpu.models import init_nonauto_model as jax_init_nonauto_model
from cfdbench_tpu.ops.spectral import spectral_conv1d_matmul
from cfdbench_tpu.training import trainer_auto as jax_trainer
from cfdbench_tpu.training.checkpoints import save_params as jax_save_params
from cfdbench_tpu.utils.artifacts import dump_json
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_auto_model
from cfdbench_tpu_torch.ops.spectral import spectral_conv1d
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.utils.artifacts import get_output_dir
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from tests.test_torch_multistep import MODEL_FLAGS, REPO, assert_metrics_close
from tests.test_torch_nonauto import NONAUTO_FLAGS
from tests.test_torch_train import (  # noqa: F401  (port_tree is a fixture)
    assert_close_rel,
    port_tree,
    result_files,
    train_argv,
)

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)

ATOL = 2e-5  # f32 forward parity
GRAD_RTOL = 1e-5  # each gradient's max abs diff over its max |grad|
FFNO_FLAGS = ["--model", "ffno", "--fno_depth", "2", "--fno_hidden_dim", "8",
              "--fno_modes_x", "5", "--fno_modes_y", "5"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("H,W,modes", [
    (16, 16, 4),
    (18, 17, 4),   # odd W
    (16, 16, 12),  # clamped to N // 2 = 8
    (17, 15, 9),   # clamped, both odd: 8 along H, 7 along W
])
def test_spectral_conv1d_matches_jax(rng, H, W, modes, axis):
    x = rng.standard_normal((2, H, W, 6)).astype(np.float32)
    w = rng.standard_normal((2, 6, 6, modes)).astype(np.float32)
    want = spectral_conv1d_matmul(jnp.asarray(x), jnp.asarray(w), modes, axis)
    got = spectral_conv1d(t(x), t(w), modes, axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def ffno_pair(argv=FFNO_FLAGS, P=5, seed=0):
    port = init_auto_model(Args.parse_args(argv), n_case_params=P,
                           generator=torch.Generator().manual_seed(seed))
    return port, jax_init_auto_model(JaxArgs.parse_args(argv), n_case_params=P)


def live_inputs(rng, B, H, W, P=5):
    mask = (rng.uniform(size=(B, H, W, 1)) > 0.2).astype(np.float32)
    return (rng.standard_normal((B, H, W, 2)).astype(np.float32),
            rng.standard_normal((B, P)).astype(np.float32), mask)


@pytest.mark.parametrize("H,W", [(16, 16), (18, 17)])
def test_ffno_forward_and_grads_match_live_jax(rng, H, W):
    """The forward at 2e-5, and the nmse's gradient of every parameter
    within 1e-5 of its max |grad| of jax.grad's, from the same weights."""
    from cfdbench_tpu import metrics as jax_metrics
    from cfdbench_tpu_torch import metrics

    port, jm = ffno_pair()
    args = live_inputs(rng, 3, H, W)
    labels = rng.standard_normal((3, H, W, 2)).astype(np.float32)
    params = params_to_flax(port.state_dict())
    want = jax.jit(jm.apply)({"params": params}, *args)
    got = port(*map(t, args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)

    metrics.loss_name_to_fn("nmse")(got, t(labels * args[2]))["nmse"].backward()
    jax_loss = jax_metrics.loss_name_to_fn("nmse")
    want_grads = jax.jit(jax.grad(
        lambda p: jax_loss(jm.apply({"params": p}, *args), labels * args[2])["nmse"]))(params)
    got_grads = params_to_flax({k: p.grad for k, p in port.named_parameters()})
    assert jax.tree.structure(got_grads) == jax.tree.structure(want_grads)
    for g, w in zip(jax.tree.leaves(got_grads), jax.tree.leaves(want_grads)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max()


def test_ffno_params_match_jax_at_default_widths():
    """Depth 4, width 32, 12 modes: the same tree, shapes and count; the
    weights round-trip bit for bit."""
    port, jm = ffno_pair(["--model", "ffno"])
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2)), jnp.zeros((1, 5)),
        jnp.ones((1, 64, 64, 1))))["params"]
    params = params_to_flax(port.state_dict())
    assert jax.tree.map(np.shape, params) == jax.tree.map(lambda a: a.shape, shapes)
    assert sum(p.numel() for p in port.parameters()) == sum(
        math.prod(a.shape) for a in jax.tree.leaves(shapes))
    back = params_from_flax(params)
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k


def auto_run(argv):
    return get_output_dir(Args.parse_args(argv), is_auto=True)


def test_main_auto_and_multistep_ffno_match_jax_end_to_end(port_tree, tmp_path, monkeypatch):
    """``main_auto --mode train_test``, 2 epochs, from the weights the
    port's CLI draws (handed to the JAX trainer in place of its init):
    the JAX run's file set, per-step train losses, dev losses and test
    scores; then each package's ``main_multistep`` rolls out its own
    trained checkpoint, 20 per-step metrics within rel 1e-4."""
    argv = FFNO_FLAGS + train_argv(port_tree, 2)[len(MODEL_FLAGS):] + ["--mode", "train_test"]
    start = init_auto_model(Args.parse_args(argv), n_case_params=5).state_dict()
    params = params_to_flax(start)
    monkeypatch.setattr(jax_trainer.AutoTask, "init_variables",
                        lambda self, rng, sample: (params, {}))
    runs = {}
    for name, main in (("jax", jax_main_auto), ("port", cli.main_auto)):
        run_argv = argv + ["--output_dir", str(tmp_path / name)]
        main(run_argv, **({"device": "cpu"} if name == "port" else {}))
        runs[name] = auto_run(run_argv)
    got_run, want_run = runs["port"], runs["jax"]
    assert result_files(got_run) == result_files(want_run)
    load = lambda run, f: json.loads((run / f).read_text())  # noqa: E731
    assert_close_rel(load(got_run, "train_losses.json"), load(want_run, "train_losses.json"),
                     "train losses")
    for ep in (0, 1):
        assert_close_rel([load(got_run, f"ckpt-{ep}/scores.json")["dev_loss"]],
                         [load(want_run, f"ckpt-{ep}/scores.json")["dev_loss"]], f"dev {ep}")
    got, want = load(got_run, "test/scores.json"), load(want_run, "test/scores.json")
    assert_close_rel(list(got["mean"].values()), list(want["mean"].values()), "test scores")

    jax_main_multistep(argv + ["--output_dir", str(tmp_path / "jax")])
    frames = cli.main_multistep(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")
    assert frames.shape == (20, frames.shape[1], 16, 16, 2)
    assert_metrics_close(load(got_run, "multistep_metrics.json"),
                         load(want_run, "multistep_metrics.json"))


@pytest.mark.parametrize("model", ["ffno", "deeponet"])
def test_export_torch_checkpoint_takes_ffno_and_nonauto_runs(synth_root, tmp_path, rng, model):
    """A JAX checkpoint in the run dir of either kind (``auto/`` for the
    FFNO, ``non-auto/`` for the DeepONet) becomes the port's
    ``model.pt``, which loads into the port's model."""
    nonauto = model == "deeponet"
    argv = (NONAUTO_FLAGS[model] if nonauto else FFNO_FLAGS) + [
        "--data_name", "cavity_prop_bc_geo", "--data_dir", str(synth_root),
        "--output_dir", str(tmp_path), "--mesh_shape", "1"]
    args = JaxArgs.parse_args(argv)
    if nonauto:
        jm = jax_init_nonauto_model(args, n_case_params=5)
        sample = (np.zeros((1, 5)), np.zeros((1, 1)), np.zeros((4, 2)))
    else:
        jm = jax_init_auto_model(args, n_case_params=5)
        sample = (np.zeros((1, 64, 64, 2)), np.zeros((1, 5)), np.ones((1, 64, 64, 1)))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *sample))["params"]
    params = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    run = get_output_dir(Args.parse_args(argv), is_auto=not nonauto)
    jax_save_params({"params": params}, run / "ckpt-0")
    dump_json(dict(ep=0, train_loss=0.0, dev_loss=0.0, time=0.0), run / "ckpt-0" / "scores.json")
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", REPO / "scripts" / "export_torch_checkpoint.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(argv) == run / "ckpt-0" / "model.pt"
    sd = ckpt.load_best_params(run)
    want = params_from_flax(params)
    assert sd.keys() == want.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
