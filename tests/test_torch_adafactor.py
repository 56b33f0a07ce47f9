"""``--opt_state_dtype factored`` in the port: ``training/optim.py``'s
Adafactor against ``optax.adafactor`` (the chain the JAX package's
``make_adam(opt_state="factored")`` builds) on the same gradients, in
flax's layout and in torch's transposed one, at shapes that factor and
shapes that do not; its factored state and its ``state_dict``; and
``main_auto`` with the flag against the JAX ``main_auto``, and across a
``--resume``."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import _factored_dims

from cfdbench_tpu.training import optim as jax_optim
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_auto_model
from cfdbench_tpu_torch.training import optim
from cfdbench_tpu_torch.utils.artifacts import get_output_dir
from cfdbench_tpu_torch.utils.flax_import import params_to_flax
from tests.test_torch_multistep import MODEL_FLAGS
from tests.test_torch_train import port_tree  # noqa: F401  (a fixture)
from tests.test_torch_train import train_argv

torch.set_num_threads(1)

LR = 1e-2
# 5 steps, 2 an epoch, the rate decayed by 0.9 an epoch.
SCHEDULE = dict(gamma=0.9, lr_step_size=1, steps_per_epoch=2)
# Flax-layout shapes: two that factor (130 x 140; the FNO's spectral
# weights at width 128, whose two 128 axes tie), a vector, a 128 x 128 tie,
# a conv kernel whose second largest axis is under 128.
SHAPES = [(130, 140), (2, 2, 128, 128, 2, 2), (7,), (128, 128), (3, 3, 4, 200)]
# Every update against optax's, over the largest |param|. Measured 1.2e-7.
ATOL = 1e-6


def to_torch_layout(a):
    """A flax-layout array in torch's: a Dense kernel transposed, a conv
    kernel (kh, kw, I, O) as (O, I, kh, kw), the rest reversed."""
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a.T


def from_torch_layout(a):
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a.T


@pytest.fixture(scope="module")
def trajectory():
    """Start values, five steps of gradients, and optax's parameters
    after them."""
    rng = np.random.default_rng(0)
    start = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    start[2][:] = 1e-4  # a tensor whose rms is under adafactor's 1e-3 floor
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(5)]
    tx = jax_optim.make_adam(LR, opt_state="factored", **SCHEDULE)
    want = [jnp.asarray(p) for p in start]
    state = tx.init(want)
    update = jax.jit(tx.update)
    for g in grads:
        updates, state = update([jnp.asarray(x) for x in g], state, want)
        want = optax.apply_updates(want, updates)
    return start, grads, [np.asarray(w) for w in want]


def run_port(start, grads, layout):
    params = [torch.nn.Parameter(torch.tensor(layout(p))) for p in start]
    opt, sched = optim.make_adam(params, LR, opt_state="factored", **SCHEDULE)
    for g in grads:
        for p, x in zip(params, g):
            p.grad = torch.tensor(layout(x))
        opt.step()
        sched.step()
    return params, opt


@pytest.mark.parametrize("layout", ["flax", "torch"])
def test_adafactor_matches_optax(trajectory, layout):
    """Five steps on the same gradients: every parameter within ATOL of the
    largest |param| of optax's, fed in flax's layout or in torch's (the
    factored estimate does not depend on which axis is the row)."""
    start, grads, want = trajectory
    to, back = ((lambda a: a), (lambda a: a)) if layout == "flax" else (
        to_torch_layout, from_torch_layout)
    params, opt = run_port(start, grads, to)
    assert isinstance(opt, optim.Adafactor)
    assert opt.param_groups[0]["lr"] == pytest.approx(LR * 0.9 ** 2)
    for p, w, s in zip(params, want, start):
        got = back(p.detach().numpy())
        assert np.abs(w - s).max() > 100 * ATOL * np.abs(w).max()  # it moved
        np.testing.assert_allclose(got, w, rtol=0, atol=ATOL * np.abs(w).max())


@pytest.mark.parametrize("shape", SHAPES + [(128, 256, 128), (256, 128, 128), (127, 300)])
def test_factored_dims_match_optax(shape):
    assert optim.factored_dims(shape) == _factored_dims(shape, True, optim.MIN_DIM_SIZE_TO_FACTOR)


def test_adafactor_state_is_factored(trajectory):
    """A tensor that factors keeps a row and a column statistic and no
    full one; the others keep the full one. In torch's layout the
    statistics are over the same two axes, transposed."""
    start, grads, _ = trajectory
    params, opt = run_port(start, grads, to_torch_layout)
    shapes = {tuple(p.shape): set(opt.state[p]) for p in params}
    assert shapes[(140, 130)] == {"step", "v_row", "v_col"}
    assert shapes[(2, 2, 128, 128, 2, 2)] == {"step", "v_row", "v_col"}
    assert shapes[(7,)] == shapes[(200, 4, 3, 3)] == {"step", "v"}
    state = opt.state[params[0]]
    assert state["step"] == 5
    # (140, 130): rows are the smaller axis, 130 statistics; the columns 140.
    assert state["v_row"].shape == (130,) and state["v_col"].shape == (140,)


def test_adafactor_state_dict_resumes_exactly(trajectory):
    """Two steps, the optimizer's state_dict through torch.save and into a
    new optimizer, three more: the same parameters as five straight."""
    start, grads, _ = trajectory
    straight, _ = run_port(start, grads, to_torch_layout)
    first, opt = run_port(start, grads[:2], to_torch_layout)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    params = [torch.nn.Parameter(p.detach().clone()) for p in first]
    opt2, sched2 = optim.make_adam(params, LR, opt_state="factored", **SCHEDULE)
    opt2.load_state_dict(torch.load(buf, weights_only=True))
    for _ in range(2):
        sched2.step()
    for g in grads[2:]:
        for p, x in zip(params, g):
            p.grad = torch.tensor(to_torch_layout(x))
        opt2.step()
        sched2.step()
    for got, want in zip(params, straight):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# A width at which the FNO's tensors factor: the spectral weights
# (2, 2, 128, 128, 2, 2), the bypass and fc1 128 x 128.
WIDE = ["--model", "fno", "--fno_hidden_dim", "128", "--fno_depth", "1",
        "--fno_modes_x", "2", "--fno_modes_y", "2"]


def wide_argv(data_root, epochs):
    return WIDE + train_argv(data_root, epochs)[len(MODEL_FLAGS):]


def test_main_auto_factored_matches_jax_end_to_end(port_tree, tmp_path, monkeypatch):
    """``main_auto --opt_state_dtype factored --mode train_test`` for an FNO
    of width 128, 2 epochs, from the port's initial weights handed to the
    JAX trainer: the per-step train losses, the dev losses and the test
    scores within rel 1e-4 of the JAX main_auto's; the saved optimizer
    state is factored."""
    from cfdbench_tpu.cli import main_auto as jax_main_auto
    from cfdbench_tpu.training import trainer_auto as jax_trainer

    argv = wide_argv(port_tree, 2) + ["--mode", "train_test", "--opt_state_dtype", "factored"]
    start = init_auto_model(Args.parse_args(argv), n_case_params=5,
                            field_shape=(16, 16)).state_dict()
    params = params_to_flax(start)
    monkeypatch.setattr(jax_trainer.AutoTask, "init_variables",
                        lambda self, rng, sample: (params, {}))
    jax_main_auto(argv + ["--output_dir", str(tmp_path / "jax")])
    cli.main_auto(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")
    want_run = get_output_dir(Args.parse_args(argv + ["--output_dir", str(tmp_path / "jax")]),
                              is_auto=True)
    got_run = get_output_dir(Args.parse_args(argv + ["--output_dir", str(tmp_path / "port")]),
                             is_auto=True)

    def load(run, name):
        return json.loads((run / name).read_text())

    def close(got, want):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4)

    close(load(got_run, "train_losses.json"), load(want_run, "train_losses.json"))
    for ep in (0, 1):
        close(load(got_run, f"ckpt-{ep}/scores.json")["dev_loss"],
              load(want_run, f"ckpt-{ep}/scores.json")["dev_loss"])
    close(list(load(got_run, "test/scores.json")["mean"].values()),
          list(load(want_run, "test/scores.json")["mean"].values()))
    state = torch.load(got_run / "training_state" / "model.pt", weights_only=True)
    assert any("v_row" in s for s in state["optimizer"]["state"].values())


def test_factored_resume_continues_as_one_run(port_tree, tmp_path):
    """One epoch, then --resume for one more, against two straight, with
    Adafactor at width 128: the same per-step losses, weights and factored
    optimizer state."""
    argv = wide_argv(port_tree, 2) + ["--mode", "train", "--plot_train_examples", "0",
                                      "--opt_state_dtype", "factored"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    cli.main_auto(argv + ["--output_dir", str(straight)], device="cpu")
    cli.main_auto(argv + ["--output_dir", str(resumed), "--num_epochs", "1"], device="cpu")
    cli.main_auto(argv + ["--output_dir", str(resumed), "--resume", "1"], device="cpu")

    def run(out):
        return get_output_dir(Args.parse_args(argv + ["--output_dir", str(out)]), is_auto=True)

    got_run, want_run = run(resumed), run(straight)
    want_losses = json.loads((want_run / "train_losses.json").read_text())
    assert json.loads((got_run / "train_losses.json").read_text()) == want_losses
    got = torch.load(got_run / "training_state" / "model.pt", weights_only=True)
    want = torch.load(want_run / "training_state" / "model.pt", weights_only=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert any("v_col" in s for s in want["optimizer"]["state"].values())
