"""The port's tensor parallelism (``parallel/sharding_rules.py``,
``parallel/tensor.py``, the FNO's split forward in ``models/fno.py``,
``training/trainer_auto.py::split_model``) on the CPU: gloo ranks spawned
as ``tests/_torch_dp_worker.py`` spawns them, against the JAX package on
one device from the same weights (the port's flax loader).

- The sharding rules: ``_spec_for`` against the JAX ``_spec_for`` on
  JAX's fallback shapes and the flagship's, and ``param_shardings`` on
  every parameter of the FNO, the U-Net, the ResNet, the FFNO and the
  point models, mapped through each parameter's flax layout.
- One Adam step of the small FNO (depth 4, width 8, 4 modes, 16x16, B=8;
  the rules' ``min_size`` 1024 as JAX's tests take it, so that the
  spectral weights and fc1 split) at ``1x2`` and ``2x2``: loss rel 1e-5,
  parameters 1e-5; each rank holds its slices; the same with fc2 split
  too (``min_size`` 256), whose gathered weight each rank's row-parallel
  head uses in part. The U-Net's loss and
  gradients (its parameters gathered at use). Adafactor at width 128 under
  ``1x2`` against JAX's factored update.
- ``main_multistep --mesh_shape 1x2`` against one process, rel 1e-4;
  ``--resume`` across meshes (``1x2`` → one process → ``1x2``), the
  checkpoints in the one-process layout.
- The refusals: what a model axis in each other entry point is still
  refused with (pipeline parallelism outside ``main_auto``, a flag the
  JAX entry point ignores, the non-autoregressive rollout's mesh), a mesh
  that does not fill the world.
- Both CUDA kernels at the shapes a model rank gives them (the block's
  ``Cout`` 16 and 8 of 32 channels, the head's 64 and 32 of 128 hidden
  units with a partial ``b2``), through their CPU emulation, against their
  plain versions.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.models.unet import UNet as JaxUNet
from cfdbench_tpu.parallel import sharding_rules as jax_rules
from cfdbench_tpu.training.optim import make_adam as jax_make_adam
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu.training.trainer_auto import TrainState, make_train_step
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.ops.spectral import init_spectral_weights
from cfdbench_tpu_torch.parallel import sharding_rules
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.utils import flax_import
from cfdbench_tpu_torch.utils.flax_import import (
    batch_stats_to_flax, params_from_flax, params_to_flax)
from tests import _torch_dp_worker as worker
from tests.test_torch_kernels import check_block_with_saved, emulation
from tests.test_torch_train import port_tree, run_dir, train_argv  # noqa: F401

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5  # JAX's own bound on a tp step's parameters
GRAD_RTOL = 1e-5  # gradients, of the largest
LR = 1e-3
MIN_SIZE = 1024  # the rules' threshold in JAX's own tp tests
FNO_WIDTHS = dict(num_layers=4, hidden_dim=8, modes1=4, modes2=4)
UNET_WIDTHS = dict(dim=4)
WIDE_WIDTHS = dict(num_layers=1, hidden_dim=128, modes1=4, modes2=4)


# --- the rules -------------------------------------------------------------

def jax_axis(spec):
    """The split axis of a JAX PartitionSpec, or None."""
    axes = [i for i, a in enumerate(spec) if a is not None]
    return axes[0] if axes else None


class Shaped:
    def __init__(self, shape):
        self.shape, self.ndim, self.size = shape, len(shape), int(np.prod(shape))


@pytest.mark.parametrize("shape,min_size", [
    ((4096, 7), 1024), ((4096, 8), 1024), ((2, 2, 8, 7, 4, 4), 16), ((8, 8), 1024),
    ((2, 2, 32, 32, 12, 12), 4096), ((32, 128), 4096), ((128, 2), 4096), ((10, 32), 4096),
    ((3, 3, 64, 64), 4096), ((128,), 16)])
def test_spec_for_matches_jax(shape, min_size):
    """The port's copy of the rule against JAX's own, on JAX's fallback
    shapes (``tests/test_parallel.py:232-254``) and the flagship's tensors."""
    want = jax_axis(jax_rules._spec_for(Shaped(shape), model_size=2, min_size=min_size))
    assert sharding_rules._spec_for(shape, 2, min_size) == want


# flax layout name → the port axis of each flax axis
PORT_AXIS = {"=": lambda a, n: a, "dense": lambda a, n: 1 - a,
             "conv": lambda a, n: {3: 0, 2: 1, 0: 2, 1: 3}[a],
             "conv_t": lambda a, n: {2: 0, 3: 1, 0: 2, 1: 3}[a]}


@pytest.mark.parametrize("name,widths", [
    ("fno", dict(num_layers=2, hidden_dim=32, modes1=12, modes2=12)), ("unet", UNET_WIDTHS),
    ("resnet", dict(hidden_chan=16, num_blocks=1, kernel_size=5, padding=2)),
    ("ffno", None), ("auto_ffn", None), ("auto_deeponet", None), ("auto_edeeponet", None)])
def test_param_shardings_match_jax(name, widths):
    """Every parameter's split axis in the port's layout is JAX's
    ``_spec_for`` on the flax tensor it maps to."""
    model = rules_model(name, widths)
    state = {k: v for k, v in model.state_dict().items()}
    flax = params_to_flax(state)
    family, shape = flax_import._port_shape(state)
    for size in (2, 4):
        got = sharding_rules.param_shardings(model, size, MIN_SIZE)
        entries = [e for e in flax_import._entries(family, shape) if e[0] == flax_import.P]
        assert {key for _, _, key, _ in entries} == set(got)
        split = 0
        for _, path, key, layout in entries:
            leaf = flax_import._get(flax, path)
            want = jax_axis(jax_rules._spec_for(leaf, size, MIN_SIZE))
            want = None if want is None else PORT_AXIS[layout](want, leaf.ndim)
            assert got[key] == want, (name, size, key, got[key], want)
            split += want is not None
        assert split, f"{name}: nothing splits at min_size {MIN_SIZE}"


def rules_model(name, widths):
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.models import init_auto_model

    if widths is not None:
        return worker.make_task(name, widths).model
    args = Args.parse_args(["--model", name, "--fno_depth", "2", "--fno_hidden_dim", "16",
                            "--fno_modes_x", "4", "--fno_modes_y", "4"])
    return init_auto_model(args, n_case_params=5, field_shape=(16, 16))


# --- one step on a mesh against JAX on one device ----------------------------

def jax_task(name, widths):
    loss = jax_loss_name_to_fn("nmse")
    if name == "unet":
        return JaxAutoTask(JaxUNet(in_chan=2, out_chan=2, n_case_params=5, **widths), loss)
    return JaxAutoTask(JaxFno2d(in_chan=2, out_chan=2, n_case_params=5, **widths), loss)


def jax_step(case):
    """The JAX trainer's step on one device: its loss, parameters after the
    step and gradients (in the port's layout)."""
    task = jax_task(case["model"], case["widths"])
    params = params_to_flax(case["state"])
    model_state = {}
    if case["model"] == "unet":
        model_state = {"batch_stats": batch_stats_to_flax(case["state"])}
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    grads, (scores, _) = jax.jit(jax.grad(
        lambda p: task.loss_scores(p, batch, model_state=model_state, train=True,
                                   rng=jax.random.PRNGKey(0)), has_aux=True))(params)
    tx = jax_make_adam(case["lr"], steps_per_epoch=10, opt_state=case.get("opt_state", "f32"))
    state = TrainState(params, model_state, tx.init(params), jnp.zeros((), jnp.int32))
    state, _ = make_train_step(task, tx, seed=0)(state, batch)
    stats = jax.device_get(state.model_state.get("batch_stats"))
    grads = params_from_flax(jax.device_get(grads), stats)
    return dict(loss=float(scores["nmse"]),
                grads={k: v for k, v in grads.items() if k in case["params"]},
                params=params_from_flax(jax.device_get(state.params), stats))


def tp_cases():
    rng = np.random.default_rng(0)
    cases = {
        "fno": dict(model="fno", widths=FNO_WIDTHS, min_size=MIN_SIZE),
        "unet": dict(model="unet", widths=UNET_WIDTHS, min_size=MIN_SIZE),
        # Each model rank's gradients of the whole parameters off by its own
        # rounding (cuDNN's on the card): their mean keeps the replicas equal.
        "unet_perturbed": dict(model="unet", widths=UNET_WIDTHS, min_size=MIN_SIZE,
                               perturb=True),
        # Width 128: the spectral weights, w0 and fc1 factor and split (the
        # JAX rules' own min_size).
        "adafactor": dict(model="fno", widths=WIDE_WIDTHS, opt_state="factored"),
        # fc2 split too (its 128x2 kernel at min_size 256): each rank's
        # row-parallel head uses its columns of the gathered fc2.
        "fno_fc2": dict(model="fno", widths=FNO_WIDTHS, min_size=256),
    }
    for case in cases.values():
        model = worker.make_task(case["model"], case["widths"]).model
        case.update(batch=worker.global_batch(rng, 8), lr=LR, state=model.state_dict(),
                    params=[n for n, _ in model.named_parameters()])
    return cases


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory):
    """Each case's step on 1x2 (and the FNO's and U-Net's on 2x2), and the
    JAX step on one device."""
    cases = tp_cases()
    root = tmp_path_factory.mktemp("tp_steps")
    ranks = {"1x2": worker.spawn(dict(kind="split_steps", mesh="1x2", cases=cases),
                                 root / "1x2"),
             "2x2": worker.spawn(dict(kind="split_steps", mesh="2x2",
                                      cases={k: cases[k] for k in ("fno", "unet", "fno_fc2")}),
                                 root / "2x2", world=4)}
    return cases, ranks, {name: jax_step(case) for name, case in cases.items()
                          if not case.get("perturb")}


def assert_step(got, want, what):
    assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=LOSS_RTOL), what
    assert got["params"].keys() == want["params"].keys()
    for k, w in want["params"].items():
        assert (got["params"][k] - w).abs().max().item() <= PARAM_ATOL, (what, k)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_fno_tp_step_matches_jax(tp_steps, mesh):
    """One Adam step: the loss and every parameter against JAX's
    one-device step; every rank alike; the split tensors hold 1/M of
    their elements on each rank, and so do their Adam moments."""
    cases, ranks, jax_results = tp_steps
    want = jax_results["fno"]
    M = int(mesh.split("x")[1])
    for r, result in enumerate(ranks[mesh]):
        got = result["fno"]
        assert_step(got, want, (mesh, r))
        for k, v in got["params"].items():
            torch.testing.assert_close(v, ranks[mesh][0]["fno"]["params"][k], rtol=0, atol=0)
        split = sharding_rules.param_shardings(worker.make_task("fno", FNO_WIDTHS).model, M,
                                               MIN_SIZE)
        sizes = {k: v.numel() for k, v in got["params"].items()}
        split_elems = sum(sizes[k] for k, d in split.items() if d is not None)
        assert split_elems > sum(sizes.values()) / 2
        assert got["local_params"] == got["whole_params"] - split_elems + split_elems // M
        assert got["opt_bytes"] == 2 * 4 * got["local_params"]
        assert got["preds"].shape == (8, 16, 16, 2)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_fno_tp_step_with_a_split_fc2_matches_jax(tp_steps, mesh):
    """fc2 split over the model ranks as well (a head of many outputs): its
    gathered weight's gradient, of which each rank's row-parallel head
    computes its columns' part, summed over the model ranks before each
    rank keeps its rows. One Adam step against JAX's."""
    _, ranks, jax_results = tp_steps
    for r, result in enumerate(ranks[mesh]):
        assert_step(result["fno_fc2"], jax_results["fno_fc2"], (mesh, r))
        assert result["fno_fc2"]["local_params"] < result["fno"]["local_params"]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_unet_tp_loss_and_gradients_match_jax(tp_steps, mesh):
    """The U-Net, each rank gathering its split convolutions at use and its
    BatchNorm summing over the data ranks: the loss and every gradient
    against JAX's (post-Adam parameters are no parity target: gradients at
    rounding level flip sign under Adam, as JAX's own test says)."""
    _, ranks, jax_results = tp_steps
    want = jax_results["unet"]
    top = max(g.abs().max().item() for g in want["grads"].values())
    for result in ranks[mesh]:
        got = result["unet"]
        assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=LOSS_RTOL)
        for k, g in want["grads"].items():
            assert (got["grads"][k] - g).abs().max().item() <= GRAD_RTOL * top, k
        assert got["local_params"] < got["whole_params"]


def test_adafactor_tp_matches_jax(tp_steps):
    """Adafactor under 1x2 at width 128, its row and column statistics and
    block RMS over the whole split tensors: the parameters after one step
    against JAX's factored update on one device."""
    _, ranks, jax_results = tp_steps
    want = jax_results["adafactor"]
    for result in ranks["1x2"]:
        got = result["adafactor"]
        assert_step(got, want, "adafactor")
        assert got["local_params"] < got["whole_params"]


# --- the entry points -----------------------------------------------------------

WIDE = ["--fno_hidden_dim", "32", "--plot_train_examples", "0", "--mode", "train"]


def tp_argv(data_root, epochs, out, mesh="1x2"):
    return train_argv(data_root, epochs) + WIDE + ["--output_dir", str(out), "--mesh_shape", mesh]


def fno_run(out: Path) -> Path:
    return run_dir(out).with_name("lr0.0001_d2_h32_m14_m24")


@pytest.fixture(scope="module")
def mesh_runs(port_tree, tmp_path_factory):  # noqa: F811
    """Two epochs in one process; one epoch on 1x2 then --resume in one
    process; one epoch in one process then --resume on 1x2; main_multistep
    of the straight run on 1x2."""
    root = tmp_path_factory.mktemp("tp_cli")
    straight = tp_argv(port_tree, 2, root / "straight", "1")
    cli.main_auto(straight, device="cpu")
    cli.main_auto(tp_argv(port_tree, 1, root / "from_one", "1"), device="cpu")
    roll = train_argv(port_tree, 2) + ["--fno_hidden_dim", "32", "--output_dir",
                                       str(root / "straight"), "--mesh_shape", "1x2"]
    frames = cli.main_multistep(straight, device="cpu")
    single = json.loads((fno_run(root / "straight") / "multistep_metrics.json").read_text())
    calls = [("main_auto", tp_argv(port_tree, 1, root / "from_mesh")),
             ("main_auto", tp_argv(port_tree, 2, root / "from_one") + ["--resume", "1"]),
             ("main_multistep", roll)]
    ranks = worker.spawn(dict(kind="cli", calls=calls), root / "ranks")
    cli.main_auto(tp_argv(port_tree, 2, root / "from_mesh", "1") + ["--resume", "1"],
                  device="cpu")
    return root, ranks, frames, single


def test_main_multistep_tp_matches_one_process(mesh_runs):
    """The rollout with the FNO's spectral weights and fc1 split over two
    model ranks: the per-step metrics within rel 1e-4 of one process's, and
    every rank's frames."""
    root, ranks, frames, single = mesh_runs
    got = json.loads((fno_run(root / "straight") / "multistep_metrics.json").read_text())
    for g, w in zip(got, single):
        for k in w:
            assert math.isclose(g[k], w[k], rel_tol=1e-4), (k, g[k], w[k])
    for result in ranks:
        assert "tensor-sharding params over 2" in result["printed"][2]
        torch.testing.assert_close(result["frames"][0], frames, rtol=0, atol=1e-5)


@pytest.mark.parametrize("first", ["from_mesh", "from_one"])
def test_resume_across_meshes(mesh_runs, first):
    """One epoch on one mesh, the second resumed on the other, against two
    epochs in one process: the per-step losses (rel 1e-5) and the weights
    (1e-5); every checkpoint and snapshot in the one-process layout."""
    root = mesh_runs[0]
    got_run, want_run = fno_run(root / first), fno_run(root / "straight")
    got = json.loads((got_run / "train_losses.json").read_text())
    want = json.loads((want_run / "train_losses.json").read_text())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert math.isclose(g, w, rel_tol=LOSS_RTOL), (g, w)
    for ep in (0, 1):
        got_w = torch.load(got_run / f"ckpt-{ep}" / ckpt.MODEL_FILE, weights_only=True)
        want_w = torch.load(want_run / f"ckpt-{ep}" / ckpt.MODEL_FILE, weights_only=True)
        assert {k: v.shape for k, v in got_w.items()} == {k: v.shape for k, v in want_w.items()}
        for k in want_w:
            torch.testing.assert_close(got_w[k], want_w[k], rtol=0, atol=1e-5)
    state = torch.load(got_run / ckpt.STATE_DIR / ckpt.MODEL_FILE, weights_only=True)
    want_state = torch.load(want_run / ckpt.STATE_DIR / ckpt.MODEL_FILE, weights_only=True)
    for i, st in want_state["optimizer"]["state"].items():
        assert {k: v.shape for k, v in state["optimizer"]["state"][i].items()} == {
            k: v.shape for k, v in st.items()}


# --- refusals -------------------------------------------------------------------

# Each entry point takes a model axis (tests/test_torch_tp_trainers*.py,
# tests/test_torch_tp_vae_bf16.py); each case, keeping its id, now pins what
# one is still refused with there: the one table of these refusals.
@pytest.mark.parametrize("entry,flags,error", [
    pytest.param("main_train", ["--model", "ffn", "--pp_microbatches", "2"], "A15e",
                 id="main_train-flags0"),
    pytest.param("main_gencast", ["--pp_microbatches", "2"], "A15e", id="main_gencast-flags1"),
    pytest.param("main_vae", ["--mode", "train", "--shard_spatial", "1"], "main_vae ignores it",
                 id="main_vae-flags2"),
    pytest.param("main_uncond", ["--shard_spatial", "1"], "train_diffusion_uncond.py ignores it",
                 id="main_uncond-flags3"),
    pytest.param("main_multistep", ["--model", "deeponet"], "ignores the mesh",
                 id="main_multistep-flags4")])
def test_model_axis_refused_by_name(tmp_path, entry, flags, error):
    argv = ["--data_dir", str(tmp_path / "data"), "--output_dir", str(tmp_path / "out"),
            "--mesh_shape", "1x2"] + flags
    with pytest.raises(NotImplementedError, match=error):
        getattr(cli, entry)(argv, device="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("spec,ranks", [("1x2", 2), ("2x2", 4)])
def test_mesh_must_fill_the_world(tmp_path, spec, ranks):
    argv = train_argv(tmp_path / "data", 1) + ["--output_dir", str(tmp_path / "out"),
                                               "--mesh_shape", spec]
    with pytest.raises(ValueError, match=f"torchrun --nproc_per_node {ranks}"):
        cli.main_auto(argv, device="cpu")


# --- the kernels at a model rank's shapes ------------------------------------

@pytest.mark.parametrize("co", [16, 8])
def test_block_kernel_at_a_ranks_channels_in_emulation(co):
    """The column-parallel block: 32 input channels, this rank's ``co`` of
    32 output channels, 12 modes; the output and what it leaves for the
    backward against the plain version."""
    lib = emulation()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 24, 20, 32), generator=gen)
    w = init_spectral_weights(gen, 32, co, 12, 12) * 32
    w0 = torch.randn((co, 32), generator=gen) / 32 ** 0.5
    b0 = torch.randn((co,), generator=gen) * 0.1
    check_block_with_saved(lambda *a, **k: fk._block_call(lib, *a, stream=0, **k),
                           (x, w, w0, b0, 12, 12))


@pytest.mark.parametrize("hidden,first", [(64, True), (32, False)])
def test_head_kernel_at_a_ranks_hidden_units_in_emulation(hidden, first):
    """The row-parallel head: this rank's ``hidden`` of 128 hidden units,
    ``b2`` on the first model rank and zeros on the others."""
    lib = emulation()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 16, 8, 32), generator=gen)
    w1 = torch.randn((hidden, 32), generator=gen) / 32 ** 0.5
    b1 = torch.randn((hidden,), generator=gen) * 0.1
    w2 = torch.randn((2, hidden), generator=gen) / 128 ** 0.5
    b2 = torch.full((2,), 0.1) if first else torch.zeros(2)
    mask = torch.ones((1, 16, 8, 1))
    mask[:, 5:9] = 0
    head = (x, w1, b1, w2, b2, mask)
    got = fk._head_call(lib, *head, stream=0)
    assert (got - fk.fno_head_reference(*head)).abs().max().item() <= 1e-5


def test_replicas_stay_equal_when_ranks_round_apart(tp_steps):
    """The U-Net's step with each model rank's gradient of every whole
    parameter off by its own ``1e-9 (rank + 1)``: the ranks'
    parameters after the step are equal, bit for bit."""
    _, ranks, _ = tp_steps
    got = [result["unet_perturbed"]["params"] for result in ranks["1x2"]]
    for k, v in got[0].items():
        assert torch.equal(v, got[1][k]), k
