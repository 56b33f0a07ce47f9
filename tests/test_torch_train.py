"""The port's training slice against the JAX package: the loss dict, the
batch pipeline, Adam with StepLR, the FNO's gradient and its SGD and
Adam trajectories against the golden torch-reference fixtures, the
kernels' autograd Functions (forward through the kernels' CPU
emulation), and ``main_auto`` end to end: its result layout and per-step
losses against the JAX ``main_auto`` from the same weights, resume, and
its refusals."""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cfdbench_tpu import metrics as jax_metrics
from cfdbench_tpu.cli import main_auto as jax_main_auto
from cfdbench_tpu.data import pipeline as jax_pipeline
from cfdbench_tpu.ops.spectral import spectral_conv2d_fft as jax_spectral_fft
from cfdbench_tpu.training import optim as jax_optim
from cfdbench_tpu_torch import cli, metrics
from cfdbench_tpu_torch.data import pipeline
from cfdbench_tpu_torch.models import init_auto_model
from cfdbench_tpu_torch.models.fno import Fno2d, fno2d_reference, lift
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.ops.spectral import clamp_modes, retained_modes, spectral_conv2d_fft
from cfdbench_tpu_torch.training import optim
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from tests._golden import trees_from_flat
from tests.test_torch_kernels import block_inputs, emulation, t
from tests.test_torch_multistep import MODEL_FLAGS, jax_params

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
SCORE_ATOL = 1e-7
LOSS_RTOL = 1e-4  # per-step train losses of the two trainers from the same weights


@pytest.mark.parametrize("case", ["unweighted", "weighted", "zero_labels", "all_padding"])
def test_score_dict_matches_jax(rng, case):
    # Predictions near their labels, as training sees them: every score
    # is below 1, so atol 1e-7 is some ten float32 ulps.
    labels = (rng.standard_normal((4, 6, 5, 2)) * 0.3).astype(np.float32)
    preds = labels + (rng.standard_normal(labels.shape) * 0.03).astype(np.float32)
    weights = {"unweighted": None, "weighted": [1, 1, 1, 0], "zero_labels": [1, 1, 0, 0],
               "all_padding": [0, 0, 0, 0]}[case]
    if case == "zero_labels":
        labels[:] = 0
    w = None if weights is None else np.asarray(weights, np.float32)
    p = t(preds).requires_grad_()
    got = metrics.score_dict(p, t(labels), True, None if w is None else t(w))
    want = jax_metrics.score_dict(preds, labels, True, w)
    assert set(got) == set(want) == {"mse", "rmse", "mae", "nmse", "nmae"}
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=0, atol=SCORE_ATOL,
                                   err_msg=key)
        g_want = jax.grad(lambda x: jax_metrics.score_dict(x, labels, True, w)[key])(preds)
        (g_got,) = torch.autograd.grad(got[key], p, retain_graph=True)
        # rmse at a zero mse has the gradient 0 * inf = NaN in both.
        np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=0, atol=SCORE_ATOL,
                                   err_msg=key)
    if case in ("zero_labels", "all_padding"):
        assert got["nmse"].item() == 0.0 and got["nmae"].item() == 0.0


@pytest.mark.parametrize(
    "H,W,modes",
    [
        (16, 16, 4),   # no Nyquist column retained
        (16, 16, 12),  # clamps to m1=8, m2=9: the Nyquist column, corners meet
        (18, 17, 4),   # odd W
    ],
)
def test_spectral_conv_gradient_matches_jax(rng, H, W, modes):
    """The block's backward differentiates the plain spectral conv: its
    adjoint follows the JAX package's clamp rule and its DC / Nyquist
    columns (atol 3e-5, the golden gradient bound)."""
    x, w, _, _ = block_inputs(rng, 2, H, W, 8, modes)
    g = rng.standard_normal((2, H, W, 8)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jax_spectral_fft(a, b, modes, modes) * g),
                    argnums=(0, 1))(x, w)
    tx, tw = t(x).requires_grad_(), t(w).requires_grad_()
    (spectral_conv2d_fft(tx, tw, modes, modes) * t(g)).sum().backward()
    for got, exp in zip((tx.grad, tw.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=3e-5)


def test_loss_names_match_jax():
    for name in ("mse", "nmse", "mae", "nmae"):
        got, want = metrics.loss_name_to_fn(name), jax_metrics.loss_name_to_fn(name)
        assert (got.normalize, got.objective) == (want.normalize, want.objective)
        assert got.get_score_names() == want.get_score_names()
    with pytest.raises(NotImplementedError):
        metrics.loss_name_to_fn("huber")


@pytest.mark.parametrize("shuffle,batch_size", [(False, 4), (True, 4), (True, 3)])
def test_batches_match_jax(rng, shuffle, batch_size):
    # 11 rows: the last batch is padded, with 0 weights on the padding.
    arrays = dict(inputs=rng.standard_normal((11, 3, 2)).astype(np.float32),
                  case_params=rng.standard_normal((11, 5)).astype(np.float32))
    got = list(pipeline.batches(arrays, batch_size, shuffle, np.random.default_rng(7)))
    want = list(jax_pipeline.batches(arrays, batch_size, shuffle, np.random.default_rng(7)))
    assert len(got) == len(want) == pipeline.num_batches(11, batch_size) == -(-11 // batch_size)
    assert got[-1]["weights"].sum() == 11 % batch_size < batch_size == got[-1]["weights"].size
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"inputs", "case_params", "weights"}
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    for g in got:
        on_device = pipeline.to_device(g, torch.device("cpu"))
        for k in g:
            np.testing.assert_array_equal(on_device[k].numpy(), g[k])


ADAM_LR = 1e-3


@pytest.mark.parametrize("opt_state", ["f32", "bf16"])
def test_make_adam_matches_optax(rng, opt_state):
    # 12 steps, 3 a epoch, the rate decayed by 0.9 each epoch: the
    # schedule must be read at the step count before the increment.
    schedule = dict(gamma=0.9, lr_step_size=1, steps_per_epoch=3)
    shapes = [(5, 7), (13,), (2, 3, 4)]
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(12)]

    tx = jax_optim.make_adam(ADAM_LR, opt_state=opt_state, **schedule)
    want = [jnp.asarray(p) for p in start]
    state = tx.init(want)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, want)
        want = optax.apply_updates(want, updates)

    params = [torch.nn.Parameter(t(p)) for p in start]
    opt, sched = optim.make_adam(params, ADAM_LR, opt_state=opt_state, **schedule)
    for g in grads:
        for p, x in zip(params, g):
            p.grad = t(x)
        opt.step()
        sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(ADAM_LR * 0.9 ** 4)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)
    if opt_state == "bf16":
        assert all(s["exp_avg"].dtype == torch.bfloat16 for s in opt.state.values())
        # A reload keeps the moments in bf16.
        opt.load_state_dict(opt.state_dict())
        assert all(s["exp_avg_sq"].dtype == torch.bfloat16 for s in opt.state.values())


def test_make_adam_refuses_factored():
    with pytest.raises(NotImplementedError, match="ROADMAP.md A18"):
        optim.make_adam([torch.nn.Parameter(torch.zeros(2))], 1e-3, opt_state="factored")


def golden_model():
    data = dict(np.load(GOLDEN / "fno.npz"))
    model = Fno2d(in_chan=2, out_chan=2, n_case_params=5, num_layers=2, modes1=4, modes2=4,
                  hidden_dim=8, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(trees_from_flat(data, ["P"])["P"]))
    return model, data


def nmse_loss(model, inputs, case_params, mask, label):
    preds = model(t(inputs), t(case_params), t(mask))
    return metrics.loss_name_to_fn("nmse")(preds, t(label) * t(mask))["nmse"]


def assert_tree_close(got_sd, want_tree, atol):
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_flax(got_sd)))
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_fno_grads_match_golden():
    """The loss and d(nmse)/d(params) of the reference's autograd on a
    fixed batch (tests/test_golden_parity.py's bounds)."""
    model, data = golden_model()
    g = dict(np.load(GOLDEN / "fno_grads.npz"))
    loss = nmse_loss(model, data["input"], data["case_params"], data["mask"], g["label"])
    loss.backward()
    assert math.isclose(loss.item(), float(g["loss_nmse"]), rel_tol=1e-5)
    assert_tree_close({k: p.grad for k, p in model.named_parameters()},
                      trees_from_flat(g, ["G"])["G"], atol=3e-5)


def trajectory_batches():
    traj = dict(np.load(GOLDEN / "fno_sgd_trajectory.npz"))
    return traj, [tuple(traj[f"b{b}_{k}"] for k in ("input", "case_params", "mask", "label"))
                  for b in (0, 1)]


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_fno_trajectory_matches_golden(name):
    """Five steps over two alternating batches: SGD's per-step losses and
    final params, Adam's losses (the port's make_adam at a constant rate)."""
    model, _ = golden_model()
    traj, batches = trajectory_batches()
    if name == "sgd":
        want, rtol = traj, 1e-5
        opt = torch.optim.SGD(model.parameters(), lr=float(traj["lr"]))
        sched = None
    else:
        want, rtol = dict(np.load(GOLDEN / "fno_adam_trajectory.npz")), 2e-5
        opt, sched = optim.make_adam(model.parameters(), float(want["lr"]), gamma=1.0)
    for step, exp_loss in enumerate(want["losses"]):
        opt.zero_grad()
        loss = nmse_loss(model, *batches[step % 2])
        assert math.isclose(loss.item(), float(exp_loss), rel_tol=rtol), (step, loss.item())
        loss.backward()
        opt.step()
        if sched is not None:
            sched.step()
    if name == "sgd":
        assert_tree_close(model.state_dict(), trees_from_flat(traj, ["F"])["F"], atol=5e-6)


@pytest.mark.parametrize(
    "H,W,modes",
    [(16, 16, 4), (16, 16, 12), (18, 17, 4), (8, 8, 12)],  # clamps: Nyquist kept; odd W
)
def test_fno_block_vjp_matches_autograd(rng, H, W, modes):
    """The block's explicit VJP, from the pre-activation and x's retained
    modes, against autograd through the plain block."""
    x, w, k0, b0 = (t(a) for a in block_inputs(rng, 2, H, W, 8, modes))
    w0 = k0.T.contiguous()
    g = t(rng.standard_normal((2, H, W, 8)))
    m1, m2 = clamp_modes(H, W, modes, modes)
    pre = spectral_conv2d_fft(x, w, modes, modes) + torch.nn.functional.linear(x, w0, b0)
    rm = retained_modes(x, m1, m2)
    got = fk.fno_block_vjp(g, x, torch.stack([rm.real, rm.imag], 1), pre, w, w0, modes, modes)
    inputs = [a.clone().requires_grad_() for a in (x, w, w0, b0)]
    want = torch.autograd.grad(fk.fno_block_reference(*inputs, modes, modes), inputs, g)
    for name, a, b in zip(("x", "weights", "w0", "b0"), got, want):
        assert a.shape == b.shape, name
        assert (a - b).abs().max().item() <= 1e-5, name


def test_kernel_functions_carry_the_plain_gradient_in_emulation(rng):
    """FnoBlockFn and FnoHeadFn with their forward launched through the
    kernels' CPU emulation, at a ragged shape: every parameter's gradient
    matches autograd through the plain versions."""
    lib = emulation()
    B, H, W, C = 2, 18, 17, 10
    model = Fno2d(in_chan=2, out_chan=3, n_case_params=5, num_layers=2, modes1=4, modes2=4,
                  hidden_dim=C, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for blk in model.blocks:  # the spectral path as large as the bypass
            blk.weights.mul_(C)
    inputs, cp = t(rng.standard_normal((B, H, W, 2))), t(rng.standard_normal((B, 5)))
    mask = torch.ones((B, H, W, 1))
    mask[:, 4:9, 3:8] = 0
    labels = t(rng.standard_normal((B, H, W, 3)))

    def through_kernels():
        x = lift(model.fc0, inputs, cp, mask)
        for blk in model.blocks:
            x = fk.FnoBlockFn.apply(lib, 0, True, x, blk.weights, blk.w0.weight, blk.w0.bias,
                                    blk.modes1, blk.modes2)
        return fk.FnoHeadFn.apply(lib, 0, x, model.fc1.weight, model.fc1.bias,
                                  model.fc2.weight, model.fc2.bias, mask)

    def grads(forward):
        model.zero_grad(set_to_none=True)
        preds = forward()
        metrics.score_dict(preds, labels * mask, True)["nmse"].backward()
        return preds.detach(), {k: p.grad for k, p in model.named_parameters()}

    before = fk.launch_counts()
    preds, got = grads(through_kernels)
    after = fk.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"fno_block": 2, "fno_head": 1}
    want_preds, want = grads(lambda: fno2d_reference(model, inputs, cp, mask))
    assert (preds - want_preds).abs().max().item() <= 1e-4
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] is not None, k
        assert (got[k] - want[k]).abs().max().item() <= 1e-5, k


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    """A cavity case tree from the port's own synthetic generator (the
    same files as the JAX package's from the same seed)."""
    from cfdbench_tpu_torch.data.synthetic import generate_problem

    root = tmp_path_factory.mktemp("port_tree")
    generate_problem(root, "cavity", cases_per_subset=4, num_frames=12, grid=16, seed=0)
    return root


def train_argv(data_root, epochs, eval_interval=1):
    return MODEL_FLAGS + [
        "--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
        "--num_epochs", str(epochs), "--batch_size", "16", "--eval_batch_size", "16",
        "--eval_interval", str(eval_interval), "--log_interval", "100", "--mesh_shape", "1",
    ]


def run_dir(root: Path) -> Path:
    return root / "auto" / "cavity_prop_bc_geo" / "dt0.1" / "fno" / "lr0.0001_d2_h8_m14_m24"


def result_files(run: Path):
    """The run's files, relative, with each weights file or directory of
    either package (model.pt, an Orbax model/ directory, model.msgpack)
    named as the port names it."""
    names = {"model": "model.pt", "model.msgpack": "model.pt", "backup_model": "backup_model.pt"}
    out = set()
    for p in run.rglob("*"):
        parts = p.relative_to(run).parts
        for i, part in enumerate(parts):
            if part in names:
                parts = (*parts[:i], names[part])
                break
        else:
            if p.is_dir():
                continue
        out.add("/".join(parts))
    return out


def json_shape(obj):
    """A JSON value's structure: dict keys, list lengths, leaf types."""
    if isinstance(obj, dict):
        return {k: json_shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [json_shape(v) for v in obj]
    return "number" if isinstance(obj, (int, float)) else type(obj).__name__


def assert_close_rel(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert math.isclose(g, w, rel_tol=LOSS_RTOL), (what, i, g, w)


def test_main_auto_matches_jax_end_to_end(port_tree, tmp_path, monkeypatch):
    """--mode train_test, 2 epochs: the JAX main_auto's file set and JSON
    layout, and its per-step train losses, dev losses and test scores
    from the weights the JAX trainer starts from (its PRNGKey(seed)
    init, carried over with params_from_flax; the CLI itself draws its
    weights from a torch.Generator)."""
    argv = train_argv(port_tree, 2) + ["--mode", "train_test"]
    jax_main_auto(argv + ["--output_dir", str(tmp_path / "jax")])

    start = params_from_flax(jax.device_get(jax_params()))

    def init_from_jax(*args, **kwargs):
        model = init_auto_model(*args, **kwargs)
        model.load_state_dict(start)
        return model

    monkeypatch.setattr(cli, "init_auto_model", init_from_jax)
    cli.main_auto(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")

    want_run, got_run = run_dir(tmp_path / "jax"), run_dir(tmp_path / "port")
    files = result_files(got_run)
    assert files == result_files(want_run)
    assert {"ckpt-0/model.pt", "ckpt-1/scores.json", "example.png", "train_losses.json",
            "training_state/model.pt", "test/preds.npy", "test/scores.json"} <= files
    for name in sorted(f for f in files if f.endswith(".json")):
        got = json.loads((got_run / name).read_text())
        want = json.loads((want_run / name).read_text())
        assert json_shape(got) == json_shape(want), name
    load = lambda run, name: json.loads((run / name).read_text())  # noqa: E731
    assert_close_rel(load(got_run, "train_losses.json"), load(want_run, "train_losses.json"),
                     "train losses")
    for ep in (0, 1):
        assert_close_rel([load(got_run, f"ckpt-{ep}/scores.json")["dev_loss"]],
                         [load(want_run, f"ckpt-{ep}/scores.json")["dev_loss"]], f"dev loss {ep}")
    got, want = load(got_run, "test/scores.json"), load(want_run, "test/scores.json")
    assert_close_rel(list(got["mean"].values()), list(want["mean"].values()), "test scores")
    np.testing.assert_allclose(np.load(got_run / "test/preds.npy"),
                               np.load(want_run / "test/preds.npy"), rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "first,total,eval_interval",
    [
        (1, 2, 1),  # one epoch, then --resume for one more
        # a finished run past its last snapshot (epoch 1): the third
        # epoch's losses are dropped from train_losses.json and retrained
        (3, 4, 2),
    ],
)
def test_resume_continues_as_one_run(port_tree, tmp_path, first, total, eval_interval):
    """``first`` epochs, then --resume to ``total``, against ``total``
    straight: the same per-step losses, weights and optimizer state."""
    argv = train_argv(port_tree, total, eval_interval) + ["--mode", "train",
                                                          "--plot_train_examples", "0"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    cli.main_auto(argv + ["--output_dir", str(straight)], device="cpu")
    cli.main_auto(argv + ["--output_dir", str(resumed), "--num_epochs", str(first)],
                  device="cpu")
    losses = json.loads((run_dir(resumed) / "train_losses.json").read_text())
    meta = json.loads((run_dir(resumed) / "training_meta.json").read_text())
    assert meta["epoch"] == first - first % eval_interval - 1
    steps = len(losses) // first
    assert steps > 0 and len(losses) == first * steps
    cli.main_auto(argv + ["--output_dir", str(resumed), "--resume", "1"], device="cpu")

    want_losses = json.loads((run_dir(straight) / "train_losses.json").read_text())
    assert len(want_losses) == total * steps
    assert json.loads((run_dir(resumed) / "train_losses.json").read_text()) == want_losses
    for name in (f"ckpt-{total - 1}/model.pt", "training_state/model.pt"):
        got = torch.load(run_dir(resumed) / name, weights_only=True)
        want = torch.load(run_dir(straight) / name, weights_only=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_main_auto_measure_time_stops_after_one_epoch(port_tree, tmp_path, capsys):
    # As the JAX main_auto: one epoch, its memory and time printed,
    # nothing saved and no test run.
    argv = train_argv(port_tree, 3) + ["--output_dir", str(tmp_path), "--mode", "train_test",
                                        "--measure_time", "1"]
    cli.main_auto(argv, device="cpu")
    out = capsys.readouterr().out
    assert "Memory usage:" in out and "Time usage:" in out
    run = run_dir(tmp_path)
    assert (run / "train_args.json").exists()
    assert not list(run.glob("ckpt-*")) and not (run / "train_losses.json").exists()
    assert not (run / "test").exists()


def test_checkpoint_falls_back_to_its_backup(tmp_path):
    from cfdbench_tpu_torch.training import checkpoints as ckpt

    ckpt.save_params({"w": torch.zeros(3)}, tmp_path)
    ckpt.save_params({"w": torch.ones(3)}, tmp_path)
    assert (tmp_path / "backup_model.pt").exists()
    torch.testing.assert_close(ckpt.load_params(tmp_path)["w"], torch.ones(3))
    # A save cut short leaves model.pt unreadable: the previous one loads.
    (tmp_path / "model.pt").write_bytes(b"PK\x03\x04 cut short")
    torch.testing.assert_close(ckpt.load_params(tmp_path)["w"], torch.zeros(3))
    (tmp_path / "model.pt").unlink()
    torch.testing.assert_close(ckpt.load_params(tmp_path)["w"], torch.zeros(3))


def test_saved_state_holds_detached_host_copies(tmp_path):
    # What save_params writes loads with a plain torch.load on a machine
    # without a card, and keeps its nest (the optimizer's betas tuple).
    from cfdbench_tpu_torch.training import checkpoints as ckpt

    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([w], lr=0.1)
    w.square().sum().backward()
    opt.step()
    ckpt.save_params(dict(params={"w": w}, optimizer=opt.state_dict(), step=1), tmp_path)
    state = torch.load(tmp_path / "model.pt", weights_only=True)
    assert state["step"] == 1
    assert state["optimizer"]["param_groups"][0]["betas"] == (0.9, 0.999)
    leaves = [state["params"]["w"], *state["optimizer"]["state"][0].values()]
    assert len(leaves) == 4
    for leaf in leaves:
        assert type(leaf) is torch.Tensor and leaf.device.type == "cpu" and not leaf.requires_grad


@pytest.mark.parametrize(
    "flags,error",
    [
        (["--use_mixed_precision"], "A6b"),
        (["--opt_state_dtype", "factored"], "A18"),
        (["--pp_microbatches", "2"], "A15"),
        (["--shard_spatial", "1"], "A15"),
        (["--mesh_shape", "2x4"], "A15"),
        (["--gradient_accumulation_steps", "4"], "ROADMAP.md C"),
        (["--use_gradient_checkpointing"], "ROADMAP.md C"),
        (["--spectral_backend", "fft"], "A17"),
        # The latent models are ported; the JAX main_auto never applies
        # remat to them (cli.py:101-160). The case keeps its id.
        pytest.param(["--model", "latent_diffusion", "--use_gradient_checkpointing"],
                     "ROADMAP.md C", id="flags8-A13"),
    ],
)
def test_main_auto_refuses_unported_flags(tmp_path, flags, error):
    argv = train_argv(tmp_path / "data", 1) + ["--output_dir", str(tmp_path / "out")] + flags
    with pytest.raises(NotImplementedError, match=error):
        cli.main_auto(argv, device="cpu")
    assert not (tmp_path / "out").exists()


def test_main_auto_needs_a_card_unless_told_cpu(port_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = train_argv(port_tree, 1) + ["--output_dir", str(tmp_path), "--mode", "train",
                                        "--plot_train_examples", "0"]
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        cli.main_auto(argv)
    assert not any(tmp_path.iterdir())
    cli.main_auto(argv, device="cpu")
    assert (run_dir(tmp_path) / "ckpt-0" / "model.pt").exists()
    # --mode test alone scores the checkpoint that training left.
    assert not (run_dir(tmp_path) / "test").exists()
    cli.main_auto(argv + ["--mode", "test"], device="cpu")
    assert "nmse" in json.loads((run_dir(tmp_path) / "test" / "scores.json").read_text())["mean"]


# The conv and point families at narrow widths, as flags of both packages.
FAMILY_FLAGS = {
    "unet": ["--model", "unet", "--unet_dim", "4"],
    "resnet": ["--model", "resnet", "--resnet_hidden_chan", "8", "--resnet_depth", "1"],
    "auto_ffn": ["--model", "auto_ffn", "--autoffn_width", "16", "--autoffn_depth", "2"],
    "auto_deeponet": ["--model", "auto_deeponet", "--deeponet_width", "16",
                      "--branch_depth", "2", "--trunk_depth", "2"],
    "auto_edeeponet": ["--model", "auto_edeeponet", "--autoedeeponet_width", "16",
                       "--autoedeeponet_depth", "2"],
    "auto_deeponet_cnn": ["--model", "auto_deeponet_cnn"],
}


def family_argv(model, data_root, epochs, eval_interval=1):
    return FAMILY_FLAGS[model] + train_argv(data_root, epochs, eval_interval)[len(MODEL_FLAGS):]


def family_run(argv) -> Path:
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.utils.artifacts import get_output_dir

    return get_output_dir(Args.parse_args(argv), is_auto=True)


def test_resnet_resume_continues_as_one_run(port_tree, tmp_path):
    """The ResNet trains with dropout on, its masks drawn from (seed,
    global step): one epoch, then --resume for a second, gives a straight
    two-epoch run's per-step losses and weights bit for bit."""
    argv = family_argv("resnet", port_tree, 2) + ["--mode", "train",
                                                  "--plot_train_examples", "0"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    cli.main_auto(argv + ["--output_dir", str(straight)], device="cpu")
    cli.main_auto(argv + ["--output_dir", str(resumed), "--num_epochs", "1"], device="cpu")
    cli.main_auto(argv + ["--output_dir", str(resumed), "--resume", "1"], device="cpu")
    runs = [family_run(argv + ["--output_dir", str(d)]) for d in (straight, resumed)]
    losses = [json.loads((r / "train_losses.json").read_text()) for r in runs]
    assert len(losses[0]) > 2 and losses[0] == losses[1]
    for name in ("ckpt-1/model.pt", "training_state/model.pt"):
        got, want = (torch.load(r / name, weights_only=True) for r in runs)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("model", list(FAMILY_FLAGS))
def test_entry_points_need_a_card_for_every_model(port_tree, tmp_path, monkeypatch, model):
    """No card and no device given: both entry points raise before they
    read or write anything; auto_deeponet_cnn's rollout raises first, on
    its own (ROADMAP.md C)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = family_argv(model, port_tree, 1) + ["--output_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        cli.main_auto(argv)
    if model == "auto_deeponet_cnn":
        with pytest.raises(ValueError, match="auto_deeponet_cnn has no rollout"):
            cli.main_multistep(argv)
    else:
        with pytest.raises(RuntimeError, match="CUDA device is required"):
            cli.main_multistep(argv)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("model", ["unet", "auto_deeponet"])
def test_main_auto_on_the_card_checks_kernel_shapes_for_the_fno_only(
        port_tree, tmp_path, monkeypatch, model):
    # Only the FNO runs the kernels: for another model the card path goes
    # straight to building it, without reading the kernels' limits.
    class Built(Exception):
        pass

    def build_model(*args, **kwargs):
        raise Built

    def no_library():
        raise AssertionError("the kernels' limits were read for a model that runs none")

    monkeypatch.setattr(fk, "load_library", no_library)
    monkeypatch.setattr(cli, "init_auto_model", build_model)
    argv = family_argv(model, port_tree, 1) + ["--output_dir", str(tmp_path),
                                               "--fno_hidden_dim", "160"]
    with pytest.raises(Built):
        cli.main_auto(argv, device="cuda")


def test_main_auto_on_the_card_refuses_shapes_its_kernels_cannot_take(
        port_tree, tmp_path, monkeypatch):
    # The kernels' limits (read from their CPU emulation) are checked on
    # the data's grid before the model is built or trained.
    def build_model(*args, **kwargs):
        raise AssertionError("the model was built before the shape check")

    monkeypatch.setattr(fk, "load_library", emulation)
    monkeypatch.setattr(cli, "init_auto_model", build_model)
    argv = train_argv(port_tree, 1) + ["--output_dir", str(tmp_path), "--fno_hidden_dim", "160"]
    with pytest.raises(ValueError, match="fno_head at width 160.*ROADMAP.md B3"):
        cli.main_auto(argv, device="cuda")
    assert not list(tmp_path.rglob("ckpt-*"))
