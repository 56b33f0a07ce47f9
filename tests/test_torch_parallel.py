"""The port's data parallelism (``cfdbench_tpu_torch/parallel/mesh.py``) on the
CPU: two ranks in spawned processes, in a gloo group that meets through a
file under the test's temporary directory (``tests/_torch_dp_worker.py``).

- One ``train_step`` of the FNO (a full batch, a global batch of 5 padded
  to 6 with a weight-0 row, and ``--use_mixed_precision``), the U-Net
  (global BatchNorm statistics, over a full batch and over 5 rows padded
  to 8) and pixel diffusion (draws over the global batch), held to the
  port's single-process step and to the JAX package's step on
  ``make_mesh("2")`` over the conftest's virtual devices, from the same
  weights; the ResNet's (dropout masks from the step's generator) and
  ``latent_diffusion2``'s (the VAE's posterior sample, the noise) held to
  the single-process step.
- The frames that ``main_multistep`` samples for pixel diffusion,
  ``latent_diffusion2`` and GenCast, each rank its block of the cases,
  against one process sampling them all.
- ``main_auto --mesh_shape 2 --mode train_test`` against the JAX
  ``main_auto --mesh_shape 2``; its checkpoint, written once, loads without
  a group; ``--resume`` on the mesh continues as one run.
- ``main_multistep --mesh_shape 2`` on the one test case (padded to two)
  against the JAX ``main_multistep --mesh_shape 2`` and the port's
  single-process rollout.
- The refusals: every axis not ported names its ROADMAP.md item, a world
  size other than ``--mesh_shape`` names ``torchrun`` in each data-parallel
  entry point, and no card means an error unless the caller asks for the
  CPU. The other trainers' data parallelism: ``test_torch_parallel_trainers.py``;
  the model axis: ``test_torch_tp.py``, ``test_torch_pp.py``.
"""

import ast
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_auto as jax_main_auto
from cfdbench_tpu.cli import main_multistep as jax_main_multistep
from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models import diffusion as jax_diffusion
from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.models.unet import UNet as JaxUNet
from cfdbench_tpu.ops import spectral as jax_spectral
from cfdbench_tpu.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh
from cfdbench_tpu.parallel.mesh import replicated_sharding
from cfdbench_tpu.training.optim import make_adam as jax_make_adam
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu.training.trainer_auto import TrainState, make_train_step
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.models.diffusion import PixelDiffusionCfdModel
from cfdbench_tpu_torch.models.fno import Fno2d
from cfdbench_tpu_torch.parallel import mesh as port_mesh
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.utils.flax_import import (
    batch_stats_to_flax,
    params_from_flax,
    params_to_flax,
)
from cfdbench_tpu_torch.utils.rng import train_key
from tests import _torch_dp_worker as worker
from tests.test_torch_diffusion import SMALL, jax_dropout_masks, jax_train_noise_and_t
from tests.test_torch_ldm import SMALL as LATENT_SMALL
from tests.test_torch_mixed_precision import TOLS as MP_TOLS
from tests.test_torch_multistep import MODEL_FLAGS, assert_metrics_close, jax_params
from tests.test_torch_train import assert_close_rel, port_tree, run_dir, train_argv  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5  # a step's scores: two ranks against one process, and against JAX
PARAM_ATOL = 1e-5  # parameters after one Adam step
GRAD_RTOL = 1e-5  # gradients, of the largest
# The bfloat16 step's gradients: each rank rounds its partial sums over its
# rows to bfloat16, one process its sums over all rows; the bound of
# test_torch_mixed_precision.py on JAX against the port.
MIXED_GRAD_RTOL = MP_TOLS["fno"][2]
FNO_WIDTHS = dict(num_layers=2, hidden_dim=8, modes1=4, modes2=4)
UNET_WIDTHS = dict(dim=4)
PIXEL_WIDTHS = {k: v for k, v in SMALL.items()}
RESNET_WIDTHS = dict(hidden_chan=8, num_blocks=1, kernel_size=5, padding=2)
LATENT_WIDTHS = dict(LATENT_SMALL)
GENCAST_WIDTHS = dict(SMALL, dropout=0.0)
STEP_LR = 1e-3
SAMPLE_STEPS = 4  # denoising steps of a sampled frame


# --- one train step ------------------------------------------------------

def port_state(case):
    return worker.make_task(case["model"], case["widths"]).model.state_dict()


def jax_task(case):
    loss = jax_loss_name_to_fn("nmse")
    if case["model"] == "pixel":
        return jax_diffusion.PixelDiffusionCfdModel(loss, 2, 5, 16, **PIXEL_WIDTHS)
    if case["model"] == "fno":
        model = JaxFno2d(in_chan=2, out_chan=2, n_case_params=5, **FNO_WIDTHS)
    else:
        model = JaxUNet(in_chan=2, out_chan=2, n_case_params=5, **UNET_WIDTHS)
    mixed = case.get("compute_dtype") is not None
    return JaxAutoTask(model, loss, compute_dtype=jnp.bfloat16 if mixed else None)


def step_cases():
    rng = np.random.default_rng(0)
    cases = {
        "fno": dict(model="fno", widths=FNO_WIDTHS, batch=worker.global_batch(rng, 8)),
        # a global batch of 5, padded to a multiple of the two ranks
        "fno_padded": dict(model="fno", widths=FNO_WIDTHS,
                           batch=worker.global_batch(rng, 6, valid=5)),
        "fno_mixed": dict(model="fno", widths=FNO_WIDTHS, batch=worker.global_batch(rng, 8),
                          compute_dtype=torch.bfloat16),
        "unet": dict(model="unet", widths=UNET_WIDTHS, batch=worker.global_batch(rng, 8)),
        # the global BatchNorm over a batch of 5 and 3 weight-0 pad rows
        "unet_padded": dict(model="unet", widths=UNET_WIDTHS,
                            batch=worker.global_batch(rng, 8, valid=5)),
        "pixel": dict(model="pixel", widths=PIXEL_WIDTHS, batch=worker.global_batch(rng, 4),
                      key=train_key(0, 0)),
        # the dropout masks over the global batch from the step's generator
        "resnet": dict(model="resnet", widths=RESNET_WIDTHS,
                       batch=worker.global_batch(rng, 6, valid=5)),
        # The frozen VAE's posterior sample, the noise and the timesteps, in
        # float64: in float32 one process's gradients stray 7.1e-6 of their
        # largest from float64's at this size (latents of 2x2),
        # so two summation orders part by up to twice that; in float64 the
        # case holds the slicing of the draws alone.
        "latent": dict(model="latent", widths=LATENT_WIDTHS, batch=worker.global_batch(rng, 4),
                       key=train_key(0, 0), dtype=torch.float64),
    }
    for case in cases.values():
        case.update(state=port_state(case), lr=STEP_LR)
    # The pixel task's draws, JAX's over the global batch: the port draws
    # over the global shape and slices, so each rank takes its rows of them.
    pixel = cases["pixel"]
    shape = pixel["batch"]["labels"][..., :2].shape
    noise, t = jax_train_noise_and_t(pixel["key"], shape, PIXEL_WIDTHS[
        "noise_scheduler_timesteps"], "cpu")
    unet = jax_task(pixel).unet
    port_unet = PixelDiffusionCfdModel(None, 2, 5, generator=torch.Generator(),
                                       **PIXEL_WIDTHS).model
    masks = jax_dropout_masks(unet)(pixel["key"], port_unet.dropout_shapes(shape),
                                    PIXEL_WIDTHS["dropout"], "cpu")
    pixel["draws"] = dict(noise=noise.numpy(), t=t.numpy(), masks=[m.numpy() for m in masks])
    return cases


def sample_cases():
    """Frames that ``main_multistep`` generates for a diffusion model, on a
    global batch of 4 cases: the sampler draws over it and slices."""
    rng = np.random.default_rng(1)
    cases = {
        "pixel": dict(model="pixel", widths=PIXEL_WIDTHS, batch=worker.global_batch(rng, 4)),
        "latent": dict(model="latent", widths=LATENT_WIDTHS, batch=worker.global_batch(rng, 4)),
        "gencast": dict(model="gencast", widths=GENCAST_WIDTHS,
                        batch=worker.global_batch(rng, 4)),
    }
    cases["gencast"]["batch"]["inputs_prev"] = rng.standard_normal((4, 16, 16, 2)).astype(
        np.float32)
    for case in cases.values():
        case.update(state=port_state(case), inference_steps=SAMPLE_STEPS)
    return cases


@pytest.fixture(scope="module")
def jax_data_shards():
    # The JAX make_mesh publishes its data-axis size process-wide; put it back.
    before = jax_spectral.AUTO_DATA_SHARDS
    yield
    jax_spectral.AUTO_DATA_SHARDS = before


@pytest.fixture(scope="module")
def steps(tmp_path_factory, jax_data_shards):
    """Each case's step on two ranks, in one process, and in JAX on a
    2-device mesh."""
    cases, samples = step_cases(), sample_cases()
    ranks = worker.spawn(dict(kind="steps", cases=cases, samples=samples),
                         tmp_path_factory.mktemp("dp_steps"))
    single = {name: worker.host_step(case, port_mesh.SINGLE) for name, case in cases.items()}
    single["samples"] = {name: worker.host_sample(case, port_mesh.SINGLE)
                         for name, case in samples.items()}
    jax_mesh = jax_make_mesh("2", tune_spectral=False)
    jax_results = {name: jax_step(cases[name], jax_mesh) for name in JAX_CASES}
    return cases, ranks, single, jax_results


def jax_step(case, mesh):
    """The JAX trainer's step on ``mesh``: params replicated, the batch
    sharded over its data axis."""
    task = jax_task(case)
    params = jax.device_put(params_to_flax(case["state"]), replicated_sharding(mesh))
    model_state = {}
    if case["model"] == "unet":
        model_state = {"batch_stats": batch_stats_to_flax(case["state"])}
    tx = jax_make_adam(case["lr"], steps_per_epoch=10)
    state = TrainState(params, model_state, tx.init(params), jnp.zeros((), jnp.int32))
    batch = jax.device_put(case["batch"], batch_sharding(mesh))
    state, scores = make_train_step(task, tx, seed=0)(state, batch)
    return dict(scores={k: float(v) for k, v in scores.items()},
                state=params_from_flax(jax.device_get(state.params),
                                       jax.device_get(state.model_state.get("batch_stats"))))


def assert_scores_close(got, want, rtol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=rtol, abs_tol=1e-12), (what, k, got[k],
                                                                               want[k])


def assert_params_close(got, want, grads, lr, grad_rtol, what):
    """Parameters after Adam's first step, which moves each by
    lr * g / (|g| + eps): where two runs' gradients may differ in sign
    (|g| below twice their bound, ``grad_rtol`` of the largest: rounding,
    such as a bias that a BatchNorm or a one-channel GroupNorm cancels in
    exact arithmetic) within 2 lr, elsewhere within PARAM_ATOL."""
    gmax = max(g.abs().max().item() for g in grads.values())
    for k, g in grads.items():
        d = (got[k] - want[k]).abs()
        big = g.abs() > 2 * grad_rtol * gmax
        if big.any():
            assert d[big].max().item() <= PARAM_ATOL, (what, k, d[big].max().item())
        assert d.max().item() <= 2 * lr + PARAM_ATOL, (what, k, d.max().item())


CASES = ["fno", "fno_padded", "fno_mixed", "unet", "unet_padded", "pixel", "resnet", "latent"]
# The cases held to JAX as well: the ResNet's masks come from a torch
# generator, which JAX's draws cannot take the place of, and the latent
# models' step differs from the pixel task's in its draws only (the VAE's
# posterior sample), which the one-process case holds to the global draw.
JAX_CASES = ["fno", "fno_padded", "fno_mixed", "unet", "unet_padded", "pixel"]


@pytest.mark.parametrize("name", CASES)
def test_step_matches_one_process(steps, name):
    """Two ranks, each on its block, against one process on the whole
    batch: the scores, the gradients (averaged over the ranks), the
    parameters after the step, identical on both ranks, and the U-Net's
    running statistics and train forward, gathered over the ranks."""
    cases, ranks, single, _ = steps
    want = single[name]
    grad_rtol = MIXED_GRAD_RTOL if "compute_dtype" in cases[name] else GRAD_RTOL
    for rank, result in enumerate(ranks):
        got = result[name]
        assert_scores_close(got["scores"], want["scores"], LOSS_RTOL, (name, rank))
        gmax = max(g.abs().max().item() for g in want["grads"].values())
        for k, g in want["grads"].items():
            assert (got["grads"][k] - g).abs().max().item() <= grad_rtol * gmax, (name, k)
        assert_params_close(got["params"], want["params"], want["grads"], cases[name]["lr"],
                            grad_rtol, (name, rank))
        out = want["output"]
        assert got["output"].shape == out.shape
        assert (got["output"] - out).abs().max().item() <= 1e-5 * out.abs().max().item()
        for k, b in want["buffers"].items():
            torch.testing.assert_close(got["buffers"][k], b, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{name} {k}: {m}")
    for k in ranks[0][name]["params"]:
        assert torch.equal(ranks[0][name]["params"][k], ranks[1][name]["params"][k]), (name, k)
    if name.startswith("unet"):
        assert want["buffers"], "the U-Net has running statistics"


@pytest.mark.parametrize("name", ["pixel", "latent", "gencast"])
def test_sampled_frames_match_one_process(steps, name):
    """A diffusion model's frames, each rank sampling its block of the
    cases, against one process sampling them all: every draw of the
    sampler is made over the global batch and sliced."""
    _, ranks, single, _ = steps
    want = single["samples"][name]
    assert torch.isfinite(want).all()
    for result in ranks:
        got = result["samples"][name]
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item(), name


@pytest.mark.parametrize("name", JAX_CASES)
def test_step_matches_jax_on_a_mesh(steps, name):
    """Two ranks against the JAX package's step on a 2-device mesh from the
    same weights: the scores, the parameters, the U-Net's running
    statistics. The bfloat16 step is held at the bounds of
    ``test_torch_mixed_precision.py`` (its scores; its gradients differ by
    bfloat16 rounding, so Adam's first step does too)."""
    cases, ranks, single, jax_results = steps
    want, got = jax_results[name], ranks[0][name]
    mixed = "compute_dtype" in cases[name]
    assert_scores_close(got["scores"], want["scores"], MP_TOLS["fno"][1] if mixed else LOSS_RTOL,
                        name)
    if not mixed:
        assert_params_close(got["params"], want["state"], single[name]["grads"],
                            cases[name]["lr"], GRAD_RTOL, name)
    stats = [k for k in got["buffers"] if k.endswith(("running_mean", "running_var"))]
    assert bool(stats) == name.startswith("unet")
    for k in stats:
        torch.testing.assert_close(got["buffers"][k], want["state"][k], rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{k}: {m}")


# --- the entry points -------------------------------------------------------

def dp_argv(argv):
    return argv + ["--mesh_shape", "2"]


@pytest.fixture(scope="module")
def auto_runs(port_tree, tmp_path_factory, jax_data_shards):  # noqa: F811
    """``main_auto --mode train_test`` for 2 epochs with --mesh_shape 2 in
    both packages, from the JAX trainer's initial weights; on the port's
    mesh also 1 epoch and then --resume for the second."""
    root = tmp_path_factory.mktemp("dp_auto")
    argv = dp_argv(train_argv(port_tree, 2) + ["--mode", "train_test"])
    jax_main_auto(argv + ["--output_dir", str(root / "jax")])
    resume = dp_argv(train_argv(port_tree, 2) + ["--mode", "train", "--plot_train_examples",
                                                  "0", "--output_dir", str(root / "resumed")])
    calls = [("main_auto", argv + ["--output_dir", str(root / "port")]),
             ("main_auto", resume + ["--num_epochs", "1"]),
             ("main_auto", resume + ["--resume", "1"])]
    init = params_from_flax(jax.device_get(jax_params()))
    worker.spawn(dict(kind="cli", calls=calls, init_state=init), root / "ranks")
    return root


def test_main_auto_on_two_ranks_matches_jax_on_two_devices(auto_runs):
    """Per-step train losses, dev losses and test scores against the JAX
    main_auto --mesh_shape 2 at the entry points' rel 1e-4, and the test
    predictions."""
    got_run, want_run = run_dir(auto_runs / "port"), run_dir(auto_runs / "jax")

    def load(run, name):
        return json.loads((run / name).read_text())

    assert_close_rel(load(got_run, "train_losses.json"), load(want_run, "train_losses.json"),
                     "train losses")
    for ep in (0, 1):
        assert_close_rel([load(got_run, f"ckpt-{ep}/scores.json")["dev_loss"]],
                         [load(want_run, f"ckpt-{ep}/scores.json")["dev_loss"]], f"dev {ep}")
    got, want = load(got_run, "test/scores.json"), load(want_run, "test/scores.json")
    assert_close_rel(list(got["mean"].values()), list(want["mean"].values()), "test scores")
    assert_close_rel(got["all"]["nmse"], want["all"]["nmse"], "test nmse per case")
    np.testing.assert_allclose(np.load(got_run / "test/preds.npy"),
                               np.load(want_run / "test/preds.npy"), rtol=0, atol=1e-4)


def test_dp_checkpoint_is_written_once_and_loads_without_a_group(auto_runs):
    """Rank 0 writes each checkpoint once (a second save would leave a
    backup beside it); it holds host tensors and loads into a model in a
    process without a group."""
    run = run_dir(auto_runs / "port")
    for ep in (0, 1):
        assert not (run / f"ckpt-{ep}" / ckpt.BACKUP_FILE).exists()
    state = torch.load(run / "ckpt-1" / ckpt.MODEL_FILE, weights_only=True)
    assert {v.device.type for v in state.values()} == {"cpu"}
    model = Fno2d(in_chan=2, out_chan=2, n_case_params=5, generator=torch.Generator(),
                  **FNO_WIDTHS)
    model.load_state_dict(state)
    assert (run / "training_state" / ckpt.MODEL_FILE).exists()


def test_resume_on_the_mesh_continues_as_one_run(auto_runs):
    """One epoch, then --resume on the mesh for the second: the straight
    run's per-step losses and weights, exactly."""
    straight, resumed = run_dir(auto_runs / "port"), run_dir(auto_runs / "resumed")
    assert (json.loads((resumed / "train_losses.json").read_text())
            == json.loads((straight / "train_losses.json").read_text()))
    got = torch.load(resumed / "ckpt-1" / ckpt.MODEL_FILE, weights_only=True)
    want = torch.load(straight / "ckpt-1" / ckpt.MODEL_FILE, weights_only=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_main_multistep_pads_the_case_axis(synth_root, tmp_path, jax_data_shards):
    """The synthetic split's one test case, padded to two with weight 0:
    the per-step metrics against the JAX main_multistep --mesh_shape 2 and
    the port's single-process run, and the frames every rank returns."""
    from tests.test_torch_multistep import write_jax_run

    run, params, argv = write_jax_run(tmp_path, synth_root)
    ckpt.save_params(params_from_flax(jax.device_get(params)), run / "ckpt-0")
    out = run / "multistep_metrics.json"
    jax_main_multistep(dp_argv(argv))
    jax_metrics = json.loads(out.read_text())
    frames = cli.main_multistep(argv, device="cpu")
    single = json.loads(out.read_text())
    out.unlink()
    ranks = worker.spawn(dict(kind="cli", calls=[("main_multistep", dp_argv(argv))]),
                         tmp_path / "ranks")
    got = json.loads(out.read_text())
    assert frames.shape[1] == 1
    assert_metrics_close(got, jax_metrics)
    for g, w in zip(got, single):
        for k in w:
            assert math.isclose(g[k], w[k], rel_tol=1e-5), (k, g[k], w[k])
    for result in ranks:
        (got_frames,) = result["frames"]
        assert got_frames.shape == frames.shape
        torch.testing.assert_close(got_frames, frames, rtol=0, atol=1e-5)


# --- refusals and launch checks -------------------------------------------

def small_argv(data_root, flags, model=MODEL_FLAGS):
    return model + ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root)] + flags


@pytest.mark.parametrize("entry,flags,error", [
    # Every trainer and the autoregressive and GenCast rollouts take a model
    # axis (tests/test_torch_tp*.py, test_torch_pp.py); what a model axis is
    # still refused with names its item. The cases keep their ids. main_auto
    # takes --shard_spatial 1 for every model (tests/test_torch_sp*.py): its
    # case pins what a latent model is still refused with (pipeline stages,
    # A15e), and main_train refuses the flag as the JAX one ignores it.
    pytest.param("main_train", ["--model", "ffn", "--mesh_shape", "2x2", "--shard_spatial", "1"],
                 "ROADMAP.md C", id="main_auto-flags0-A15c"),
    pytest.param("main_multistep", ["--model", "ffn", "--mesh_shape", "2x2"], "ROADMAP.md C",
                 id="main_multistep-flags1-A15c"),
    pytest.param("main_auto", ["--model", "latent_diffusion2", "--mesh_shape", "1x2",
                               "--shard_spatial", "1", "--pp_microbatches", "2"], "A15e",
                 id="main_auto-flags2-A15d"),
    pytest.param("main_train", ["--model", "ffn", "--pp_microbatches", "2"], "A15e",
                 id="main_auto-flags3-A15e"),
    ("main_multistep", ["--model", "deeponet", "--mesh_shape", "2"], "ROADMAP.md C"),
])
def test_axes_not_ported_raise_by_name(tmp_path, entry, flags, error):
    argv = small_argv(tmp_path / "data", flags + ["--output_dir", str(tmp_path / "out")])
    with pytest.raises(NotImplementedError, match=error):
        getattr(cli, entry)(argv, device="cpu")
    assert not (tmp_path / "out").exists()


# Each data-parallel entry point, with the flags it needs besides the data's.
DP_ENTRIES = {"main_auto": [], "main_multistep": [], "main_train": ["--model", "ffn"],
              "main_gencast": [], "main_vae": ["--mode", "train"],
              "main_uncond": ["--mode", "train"]}


@pytest.mark.parametrize("entry,mesh_shape", [
    ("main_auto", "2"), ("main_multistep", "4x1"), ("main_train", "2"), ("main_gencast", "3x1"),
    ("main_vae", "2"), ("main_uncond", "4")])
def test_world_size_must_match_the_mesh(tmp_path, entry, mesh_shape):
    """One process asked for a mesh of several ranks names the launcher."""
    argv = small_argv(tmp_path / "data", ["--mesh_shape", mesh_shape,
                                          "--output_dir", str(tmp_path / "out")]
                      + DP_ENTRIES[entry])
    n = mesh_shape.split("x")[0]
    with pytest.raises(ValueError, match=f"torchrun --nproc_per_node {n}"):
        getattr(cli, entry)(argv, device="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("entry", list(DP_ENTRIES))
def test_dp_entry_points_need_a_card_unless_told_cpu(tmp_path, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = small_argv(tmp_path / "data", ["--mesh_shape", "2",
                                          "--output_dir", str(tmp_path / "out")]
                      + DP_ENTRIES[entry])
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        getattr(cli, entry)(argv)


def test_a_local_rank_beyond_the_cards_raises(monkeypatch):
    from cfdbench_tpu_torch.utils.device import require_cuda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 but this machine has 1"):
        require_cuda()


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda:0", "nccl")])
def test_open_mesh_initialises_a_group_under_torchrun(tmp_path, monkeypatch, device, backend):
    """Under a launcher (``WORLD_SIZE`` set) with no group yet, the entry
    point's mesh opens one, NCCL on the card and gloo on the CPU, and
    destroys it on exit; here it meets through a file, not a TCP port."""
    import torch.distributed as dist

    opened = []
    real = dist.init_process_group

    def init(backend, init_method=None):
        opened.append((backend, init_method))
        real("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert port_mesh.data_size("auto") == 1
    with port_mesh.open_mesh("auto", device) as mesh:
        assert mesh.group is not None and (mesh.size, mesh.rank) == (1, 0) and mesh.is_main()
        assert "backend=gloo" in repr(mesh)
        # A group of one runs no collective: the step is one process's.
        assert not mesh.distributed
        x = torch.arange(4.0, requires_grad=True)
        assert mesh.sum(x) is x and mesh.max(x) is x
    assert opened == [(backend, "env://")] and not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert port_mesh.data_size("auto") == 3 and port_mesh.data_size("2x1") == 2


def test_parallel_imports_torch_only():
    allowed = {"__future__", "contextlib", "os", "typing", "torch"}
    for path in (REPO / "cfdbench_tpu_torch" / "parallel").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, (path.name, ast.unparse(node))
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert roots <= allowed, (path.name, ast.unparse(node))
