"""The port's conv family (U-Net, ResNet) and point family (Auto-FFN,
Auto-DeepONet, Auto-EDeepONet, Auto-DeepONetCNN) against the JAX package
and the golden torch-reference fixtures: forwards (2e-5), the weight
mapping both ways, gradients and Adam trajectories at the golden tests'
own bounds, parameter counts at the default widths, live JAX parity at
an odd grid, the U-Net's BatchNorm running statistics after a train-mode
step, and the ResNet's dropout."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.config import Args as JaxArgs
from cfdbench_tpu.models import init_auto_model as jax_init_auto_model
from cfdbench_tpu.models.point import AutoDeepONetCnn as JaxAutoDeepONetCnn
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.metrics import loss_name_to_fn
from cfdbench_tpu_torch.models import AutoDeepONetCnn, init_auto_model
from cfdbench_tpu_torch.models.resnet import DROPOUT
from cfdbench_tpu_torch.training import optim
from cfdbench_tpu_torch.training.trainer_auto import AutoTask, step_generator
from cfdbench_tpu_torch.utils.flax_import import (
    batch_stats_to_flax,
    params_from_flax,
    params_to_flax,
)
from tests._golden import trees_from_flat
from tests.test_models import GOLDEN_COUNTS
from tests.test_models import _make as jax_default_model

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
ATOL = 2e-5  # f32 forward parity, the JAX package's own golden bound

# The golden fixtures' configurations (tests/test_golden_parity.py:71-127),
# as flags of both packages' init_auto_model.
GOLDEN_FLAGS = {
    "unet_input": ["--model", "unet", "--unet_dim", "4"],
    "unet_hidden": ["--model", "unet", "--unet_dim", "4",
                    "--unet_insert_case_params_at", "hidden"],
    "resnet": ["--model", "resnet", "--resnet_hidden_chan", "8", "--resnet_depth", "2",
               "--resnet_kernel_size", "5", "--resnet_padding", "2"],
    "auto_deeponet": ["--model", "auto_deeponet", "--deeponet_width", "16",
                      "--branch_depth", "2", "--trunk_depth", "2"],
    "auto_ffn": ["--model", "auto_ffn", "--autoffn_width", "16", "--autoffn_depth", "2"],
    "auto_edeeponet": ["--model", "auto_edeeponet", "--autoedeeponet_width", "16",
                       "--autoedeeponet_depth", "2"],
    "auto_deeponet_cnn": ["--model", "auto_deeponet_cnn"],
}
CNN_TRUNK_DEPTH = 2  # the golden's; no flag sets it (JAX models/__init__.py:121-127)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def golden(name):
    data = dict(np.load(GOLDEN / f"{name}.npz"))
    trees = trees_from_flat(data, ["P", "S"])
    return trees["P"], trees["S"] or None, data


def port_model(name, field_shape, params, stats=None, P=5):
    gen = torch.Generator().manual_seed(0)
    if name == "auto_deeponet_cnn":
        model = AutoDeepONetCnn(2, P, field_shape, trunk_depth=CNN_TRUNK_DEPTH, generator=gen)
    else:
        model = init_auto_model(Args.parse_args(GOLDEN_FLAGS[name]), n_case_params=P,
                                field_shape=field_shape, generator=gen)
    if params is not None:
        model.load_state_dict(params_from_flax(jax.device_get(params), jax.device_get(stats)))
    return model


def jax_model(name, field_shape, P=5):
    if name == "auto_deeponet_cnn":
        return JaxAutoDeepONetCnn(in_chan=2, num_case_params=P, trunk_depth=CNN_TRUNK_DEPTH)
    return jax_init_auto_model(JaxArgs.parse_args(GOLDEN_FLAGS[name]), n_case_params=P,
                               field_shape=field_shape)


def jax_apply(model, params, stats, *args, train=False):
    """The JAX model's forward, jitted (one compile, not one per op);
    in training also the updated ``batch_stats``."""
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    mutable = ["batch_stats"] if train else False
    return jax.jit(lambda v, *a: model.apply(v, *a, train=train, mutable=mutable))(
        variables, *args)


def as_frame(out, expected_shape):
    return np.asarray(out).reshape(expected_shape)  # point models give (B, H*W)


@pytest.mark.parametrize("name", list(GOLDEN_FLAGS))
def test_forward_matches_golden_and_live_jax(name):
    params, stats, data = golden(name)
    field = data["input"].shape[1:3]
    model = port_model(name, field, params, stats).eval()
    args = (data["input"], data["case_params"], data["mask"])
    with torch.no_grad():
        got = as_frame(model(*map(t, args)), data["expected"].shape)
    np.testing.assert_allclose(got, data["expected"], rtol=0, atol=ATOL)
    want = jax_apply(jax_model(name, field), params, stats, *args)
    np.testing.assert_allclose(got, as_frame(want, got.shape), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(GOLDEN_FLAGS))
def test_weights_round_trip(name):
    """flax → the port's state dict → flax, bit for bit; the state dict's
    keys are the reference torch model's (what the JAX package's
    torch_import reads)."""
    from cfdbench_tpu.utils.torch_import import import_state_dict

    params, stats, _ = golden(name)
    sd = params_from_flax(params, stats)
    back = {"params": params_to_flax(sd), "batch_stats": batch_stats_to_flax(sd)}
    want = {"params": params, "batch_stats": stats or {}}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    model = name.split("_input")[0].split("_hidden")[0]
    ref = import_state_dict(model, {k: v.numpy() for k, v in sd.items()})
    assert len(jax.tree.leaves(ref)) == len(jax.tree.leaves(want))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def nmse(out, label, mask, pointwise):
    if pointwise:
        label = label[..., :1].reshape(label.shape[0], -1)
    else:
        label = label * mask
    return loss_name_to_fn("nmse")(out, label)["nmse"]


@pytest.mark.parametrize("name,fixture,atol", [("unet_input", "unet_grads", 1e-4),
                                               ("resnet", "resnet_grads", 3e-5)])
def test_grads_match_golden(name, fixture, atol):
    """The loss and d(nmse)/d(params) of the reference's autograd, in eval
    mode (tests/test_golden_parity.py's bounds)."""
    params, stats, data = golden(name)
    g = dict(np.load(GOLDEN / f"{fixture}.npz"))
    model = port_model(name, data["input"].shape[1:3], params, stats).eval()
    out = model(*(t(data[k]) for k in ("input", "case_params", "mask")))
    loss = nmse(out, t(g["label"]), t(data["mask"]), False)
    loss.backward()
    assert np.isclose(loss.item(), float(g["loss_nmse"]), rtol=1e-5)
    got = params_to_flax({k: p.grad for k, p in model.named_parameters()})
    want = trees_from_flat(g, ["G"])["G"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize(
    "name,train,rtols",
    [
        # Train mode: BatchNorm on batch statistics with running-stat
        # updates; the golden test's own per-step bounds (rounding grows
        # through BatchNorm and Adam's rsqrt, test_golden_parity.py:435-443).
        ("unet_input", True, (1e-5, 1e-4, 1e-3, 1.5e-2, 4e-2)),
        ("resnet", False, (3e-5,) * 5),  # eval mode: dropout off
        ("auto_deeponet", False, (2e-5,) * 5),
    ],
)
def test_adam_trajectory_matches_golden(name, train, rtols):
    """5 Adam steps over two alternating batches: the reference's per-step
    losses, through the port's make_adam at a constant rate."""
    params, stats, _ = golden(name)
    fixture = name.replace("_input", "")
    traj = dict(np.load(GOLDEN / f"{fixture}_adam_trajectory.npz"))
    model = port_model(name, traj["b0_input"].shape[1:3], params, stats)
    model.train(train)
    opt, sched = optim.make_adam(model.parameters(), float(traj["lr"]), gamma=1.0)
    pointwise = getattr(model, "pointwise", False)
    for step, (want, rtol) in enumerate(zip(traj["losses"], rtols)):
        b = step % 2
        opt.zero_grad()
        out = model(*(t(traj[f"b{b}_{k}"]) for k in ("input", "case_params", "mask")))
        loss = nmse(out, t(traj[f"b{b}_label"]), t(traj[f"b{b}_mask"]), pointwise)
        assert np.isclose(loss.item(), float(want), rtol=rtol), (step, loss.item(), want)
        loss.backward()
        opt.step()
        sched.step()


@pytest.mark.parametrize("name", [n for n in GOLDEN_COUNTS if n != "fno"])
def test_param_counts_match_jax_at_default_widths(name):
    # tests/test_models.py's configuration: 64x64, 5 case parameters.
    args = Args(model=name, fno_hidden_dim=32, branch_depth=8, trunk_depth=8,
                autoedeeponet_depth=8, resnet_hidden_chan=16)
    model = init_auto_model(args, n_case_params=5, field_shape=(64, 64),
                            generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == GOLDEN_COUNTS[name][0]
    variables = jax.eval_shape(lambda: jax_default_model(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2)), jnp.zeros((1, 5)),
        jnp.ones((1, 64, 64, 1))))
    want = {"params": jax.tree.leaves(variables["params"]),
            "batch_stats": jax.tree.leaves(variables.get("batch_stats", {}))}
    got = {"params": jax.tree.leaves(params_to_flax(model.state_dict())),
           "batch_stats": jax.tree.leaves(batch_stats_to_flax(model.state_dict()))}
    for coll in want:
        assert [a.shape for a in got[coll]] == [b.shape for b in want[coll]], coll


def live_inputs(rng, B, H, W, P=5):
    mask = np.ones((B, H, W, 1), np.float32)
    mask[:, H // 4: H // 2, W // 3: W // 2] = 0
    return (rng.standard_normal((B, H, W, 2)).astype(np.float32),
            rng.standard_normal((B, P)).astype(np.float32), mask)


def port_init(name, H, W, rng, P=5):
    """A port model from its seeded init, the U-Net's running statistics
    set off their init values, and its variables as flax trees."""
    model = port_model(name, (H, W), None)
    with torch.no_grad():
        for k, buf in model.named_buffers():
            if k.endswith(("running_mean", "running_var")):
                buf.copy_(t(rng.uniform(0.5, 2.0, buf.shape)))
    sd = model.state_dict()
    return model, params_to_flax(sd), batch_stats_to_flax(sd) or None


@pytest.mark.parametrize("name,H,W", [
    ("unet_input", 18, 17),   # the Up blocks' pad branch on both axes
    ("unet_hidden", 18, 17),
    ("resnet", 18, 17),
    ("auto_ffn", 18, 17),
    ("auto_deeponet", 18, 17),
    ("auto_edeeponet", 18, 17),
    ("auto_deeponet_cnn", 34, 33),  # the CNN branch pools 16x: a 2x2 code
])
def test_eval_forward_matches_live_jax_at_odd_grids(rng, name, H, W):
    """The port's seeded weights carried to the JAX model, at an odd
    grid, eval mode."""
    model, params, stats = port_init(name, H, W, rng)
    args = live_inputs(rng, 3, H, W)
    want = jax_apply(jax_model(name, (H, W)), params, stats, *args)
    got = model.eval()(*map(t, args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("H,W", [(16, 16), (18, 17)])
def test_unet_batchnorm_matches_flax_in_training(rng, H, W):
    """One train-mode forward at batch 8: the output (normalised by the
    batch statistics) and the running mean and variance it leaves — the
    biased batch variance, as flax stores it — against flax's
    ``batch_stats``; then an eval-mode forward on those statistics."""
    jm = jax_model("unet_input", (H, W))
    model, params, stats = port_init("unet_input", H, W, rng)
    args = live_inputs(rng, 8, H, W)
    want, new = jax_apply(jm, params, stats, *args, train=True)
    got = model.train()(*map(t, args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    got_stats = batch_stats_to_flax(model.state_dict())
    want_stats = jax.device_get(new["batch_stats"])
    assert jax.tree.structure(got_stats) == jax.tree.structure(want_stats)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got_stats),
                            jax.tree.leaves(want_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    # The bottleneck's variance over 8 x 1 x 1 values: torch's unbiased
    # estimate would store 8/7 times the batch's share.
    assert all(int(v) == 1 for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked"))
    model.eval()
    want_eval = jax_apply(jm, params, new["batch_stats"], *args)
    np.testing.assert_allclose(model(*map(t, args)).detach().numpy(), np.asarray(want_eval),
                               rtol=0, atol=ATOL)


def resnet_task(hidden=8):
    model = init_auto_model(Args.parse_args(GOLDEN_FLAGS["resnet"][:2] + [
        "--resnet_hidden_chan", str(hidden), "--resnet_depth", "1"]),
        n_case_params=5, field_shape=(16, 16), generator=torch.Generator().manual_seed(0))
    return AutoTask(model, loss_name_to_fn("nmse"))


def test_resnet_dropout_rate_and_scale():
    """In training each hidden activation is kept with probability 0.8
    and scaled by 1/0.8 (flax's Dropout); eval mode draws nothing."""
    from cfdbench_tpu_torch.models.resnet import dropout

    x = torch.full((64, 16, 16, 64), 3.0)
    y = dropout(x, DROPOUT, step_generator(0, 5, "cpu"))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - DROPOUT)) < 0.005
    assert torch.all(y[kept] == 3.0 / (1 - DROPOUT))
    task = resnet_task()
    task.model.eval()
    args = [t(a) for a in live_inputs(np.random.default_rng(0), 2, 16, 16)]
    torch.testing.assert_close(task.forward(*args), task.forward(*args), rtol=0, atol=0)
    task.model.train()
    with pytest.raises(ValueError, match="Generator"):
        task.forward(*args)


def test_resnet_dropout_masks_follow_seed_and_step():
    """The same (seed, step) draws the same masks; another step or seed
    draws others; eval mode equals no dropout."""
    task = resnet_task()
    task.model.train()
    args = [t(a) for a in live_inputs(np.random.default_rng(0), 2, 16, 16)]

    def run(seed, step):
        return task.forward(*args, generator=step_generator(seed, step, "cpu"))

    torch.testing.assert_close(run(0, 3), run(0, 3), rtol=0, atol=0)
    for other in (run(0, 4), run(1, 3)):
        assert (other - run(0, 3)).abs().max().item() > 1e-3
