"""A model axis in ``main_vae`` and the bfloat16 forward over a model axis
(A15f) on the CPU: gloo ranks at ``--mesh_shape 1x2``
(``tests/_torch_dp_worker.py``) against the port's one process and the
JAX package.

- ``main_vae`` (the lite VAE, split by the JAX rules at their own
  ``min_size``) against one process, rel 1e-4: its loss history, its best
  weights in the one-process layout; those weights, unchanged, as the
  frozen VAE of a ``latent_diffusion2`` ``main_auto`` in one process,
  whose losses match the run on one process's VAE.
- ``main_multistep --rollout_dtype bfloat16`` of the FNO (its spectral
  weights, fc1 and fc2 split) and of the U-Net (gathered at use) at
  ``1x2``: the frames and per-step metrics against one process's bfloat16
  rollout and against JAX's, at ``test_torch_bf16_rollout.py``'s bounds.
- The FNO's ``--use_mixed_precision`` train step at ``1x2`` under tp (its
  split blocks and head on the plain versions, in bfloat16) and under pp
  (the stages on bfloat16 copies), against one process in bfloat16 and
  against JAX's bfloat16 step at ``test_torch_mixed_precision.py``'s
  bounds; the U-Net's, its split weights' bfloat16 copies gathered at
  use, against one process's exactly.

What a model axis is still refused with: ``test_torch_tp.py``.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_multistep as jax_main_multistep
from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.training import rollout as jax_rollout
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.parallel import mesh as port_mesh
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from tests import _torch_dp_worker as worker
from tests.test_torch_bf16_rollout import TOLS as ROLLOUT_TOLS
from tests.test_torch_bf16_rollout import argv_for, write_checkpoint
from tests.test_torch_ldm_cli import ldm_argv
from tests.test_torch_mixed_precision import TOLS as MP_TOLS
from tests.test_torch_train import family_run, port_tree, result_files  # noqa: F401
from tests.test_torch_vae import tiny_tree  # noqa: F401  (a fixture)

torch.set_num_threads(1)

RTOL = 1e-4  # two ranks against one process through an entry point
MESH = ["--mesh_shape", "1x2"]
ROLLOUT_MODELS = ("fno", "unet")
BF16 = ["--rollout_dtype", "bfloat16"]
# The narrow rollout models split at this threshold of the rules.
CONSTANTS = [("cfdbench_tpu_torch.parallel.sharding_rules", "MIN_SIZE", 256)]
# The bfloat16 rollout on two model ranks against one process's: the frames
# (of their max) and the per-step metrics (each metric's largest difference
# over its largest value). The row-parallel head's partial outputs are
# rounded to bfloat16 before they are summed; the U-Net's gathered weights
# are its own. Measured on the CPU: the FNO 7.4e-3 and 5.3e-5, the U-Net 0
# and 0. The FNO's bounds are 4x its measurements.
TP_ROLLOUT_TOLS = {"fno": (3e-2, 2.2e-4), "unet": (0.0, 0.0)}


def vae_argv(data_root, out):
    return ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(out / "result"), "--ldm_vae_weights_path", str(out / "w"),
            "--num_epochs", "1", "--batch_size", "8", "--mode", "train"]


def vae_run(out):
    return out / "result" / "vae" / "cavity_prop_bc_geo"


@pytest.fixture(scope="module")
def runs(port_tree, tiny_tree, tmp_path_factory):  # noqa: F811
    """main_vae in one process and on 1x2; the bfloat16 rollouts of one
    checkpoint per model in JAX, in one process and on 1x2; then
    latent_diffusion2's main_auto in one process on each VAE."""
    root = tmp_path_factory.mktemp("tp_vae_bf16")
    rng = np.random.default_rng(0)
    single = {"vae": cli.main_vae(vae_argv(tiny_tree, root / "one_vae"), device="cpu")}
    calls = [("main_vae", vae_argv(tiny_tree, root / "mesh_vae") + MESH)]
    jax_frames = {}
    for model in ROLLOUT_MODELS:
        argv = argv_for(model, port_tree, root / model)
        write_checkpoint(argv, rng)
        seen = []
        metrics = jax_rollout.multistep_metrics

        def keep(preds, *args, **kwargs):
            seen.append(np.asarray(preds, np.float32))
            return metrics(preds, *args, **kwargs)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_rollout, "multistep_metrics", keep)
            jax_main_multistep(argv + BF16)
        run = family_run(argv)
        jax_frames[model] = (seen[0], json.loads((run / "multistep_metrics.json").read_text()))
        single[model] = (cli.main_multistep(argv + BF16, device="cpu").float(),
                         json.loads((run / "multistep_metrics.json").read_text()))
        calls.append(("main_multistep", argv + BF16 + MESH))
    ranks = worker.spawn(dict(kind="cli", calls=calls, constants=CONSTANTS), root / "ranks")
    ldm = {}
    for which in ("one", "mesh"):
        task = cli.main_auto(ldm_argv(port_tree, root / f"{which}_ldm", root / f"{which}_vae" / "w")
                             + ["--num_epochs", "1", "--mode", "train"], device="cpu")
        ldm[which] = (task, root / f"{which}_ldm")
    return root, ranks, single, jax_frames, ldm


def test_main_vae_on_a_model_axis_matches_one_process(runs):
    """``main_vae --mesh_shape 1x2``: its files, its loss history against
    one process's, and the best weights, which both ranks return alike and
    rank 0 wrote in the one-process layout, within RTOL of one process's."""
    root, ranks, single, _, _ = runs
    got_run, want_run = vae_run(root / "mesh_vae"), vae_run(root / "one_vae")
    assert result_files(got_run) == result_files(want_run)
    got, want = (json.loads((r / "loss_history.json").read_text()) for r in (got_run, want_run))
    for k, w in want.items():
        for g, v in zip(got[k], w):
            assert math.isclose(g, v, rel_tol=RTOL), (k, g, v)
    torch.testing.assert_close(ranks[0]["states"][0], ranks[1]["states"][0], rtol=0, atol=0)
    saved = ckpt.load_params(root / "mesh_vae" / "w")
    for k, w in single["vae"].items():
        assert saved[k].shape == w.shape, k
        assert (saved[k] - w).abs().max().item() <= RTOL * w.abs().max().item() + 1e-12, k
        torch.testing.assert_close(ranks[0]["states"][0][k], saved[k], rtol=0, atol=0)
    assert " on this rank)" in ranks[0]["printed"][0]


def test_model_axis_vae_loads_into_a_one_process_ldm(runs):
    """The 1x2 VAE's weights, unchanged, as the frozen VAE of a
    latent_diffusion2 trained in one process: the task's VAE holds them,
    and its per-step losses match the run on one process's VAE."""
    root, _, _, _, ldm = runs
    task, run = ldm["mesh"]
    saved = ckpt.load_params(root / "mesh_vae" / "w")
    for k, v in task.vae.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    losses = {w: json.loads((cli.run_dir(cli.parse_args(ldm_argv("", r, ""))) /
                             "train_losses.json").read_text()) for w, (_, r) in ldm.items()}
    assert len(losses["mesh"]) == len(losses["one"]) > 0
    for g, w in zip(losses["mesh"], losses["one"]):
        assert math.isclose(g, w, rel_tol=RTOL), (g, w)


@pytest.mark.parametrize("model", ROLLOUT_MODELS)
def test_bf16_rollout_on_a_model_axis_matches_one_process(runs, model):
    """``main_multistep --rollout_dtype bfloat16 --mesh_shape 1x2``: both
    ranks' frames (bfloat16) and the per-step metrics against one
    process's bfloat16 rollout of the same checkpoint."""
    _, ranks, single, _, _ = runs
    want_frames, want = single[model]
    call = 1 + ROLLOUT_MODELS.index(model)
    frame_tol, metric_tol = TP_ROLLOUT_TOLS[model]
    for r in ranks:
        assert "tensor-sharding params over 2" in r["printed"][call]
        got = r["frames"][call - 1]
        assert got.dtype == torch.bfloat16
        err = (got.float() - want_frames).abs().max().item()
        assert err <= frame_tol * want_frames.abs().max().item(), err
    got = rank_metrics(runs, model)
    for k in want[0]:
        top = max(abs(w[k]) for w in want)
        assert max(abs(g[k] - w[k]) for g, w in zip(got, want)) <= metric_tol * top, k


def rank_metrics(runs, model):
    """The per-step metrics that rank 0 of the 1x2 rollout wrote, the last
    rollout of the checkpoint's run."""
    root = runs[0]
    run = family_run(argv_for(model, "", root / model))
    return json.loads((run / "multistep_metrics.json").read_text())


@pytest.mark.parametrize("model", ROLLOUT_MODELS)
def test_bf16_rollout_on_a_model_axis_matches_jax(runs, model):
    """The same 1x2 rollout against JAX's bfloat16 rollout on one device, at
    the model's bounds in ``test_torch_bf16_rollout.py``."""
    _, ranks, _, jax_frames, _ = runs
    want_frames, want = jax_frames[model]
    frame_tol, metric_tol = ROLLOUT_TOLS[model]
    got_frames = ranks[0]["frames"][ROLLOUT_MODELS.index(model)].float().numpy()
    assert np.abs(got_frames - want_frames).max() <= frame_tol * np.abs(want_frames).max()
    got = rank_metrics(runs, model)
    assert len(got) == len(want) == 20
    for k in want[0]:
        top = max(abs(w[k]) for w in want)
        assert max(abs(g[k] - w[k]) for g, w in zip(got, want)) <= metric_tol * top, k


# --- the FNO's bfloat16 train step over a model axis -------------------------

FNO_WIDTHS = dict(num_layers=4, hidden_dim=8, modes1=4, modes2=4)
UNET_WIDTHS = dict(dim=4)
BF16_CASES = {"tp": {}, "pp": {"pp": 2}}
LR = 1e-3
# The bfloat16 step over the model axis against one process's: the loss
# (relative) and the gradients (of the largest). The partial outputs of the
# row-parallel head are rounded to bfloat16 before they are summed, and a
# microbatch's bfloat16 sums differ from the whole batch's. Measured on the
# CPU: tp 2.3e-6 and 1.41e-3, pp 2.4e-6 and 8.8e-4; each bound is about 4x
# the larger. The port's bfloat16 gradients are off its float32 ones by
# 9.5e-3 of the largest: more than SEPARATION shows that bfloat16 ran.
BF16_LOSS_RTOL = 1e-5
BF16_GRAD_RTOL = 6e-3
SEPARATION = 1e-3


@pytest.fixture(scope="module")
def bf16_steps(tmp_path_factory):
    """The FNO's bfloat16 train step under tp and pp at 1x2 (the rules at
    JAX's test threshold, 1024), in one process, and JAX's bfloat16 loss
    and gradients on one device."""
    rng = np.random.default_rng(3)
    model = worker.make_task("fno", FNO_WIDTHS).model
    batch = worker.global_batch(rng, 8)
    cases = {name: dict(model="fno", widths=FNO_WIDTHS, min_size=1024, lr=LR,
                        compute_dtype=torch.bfloat16, batch=batch, state=model.state_dict(),
                        **extra)
             for name, extra in BF16_CASES.items()}
    unet = worker.make_task("unet", UNET_WIDTHS).model
    cases["unet"] = dict(cases["tp"], model="unet", widths=UNET_WIDTHS, state=unet.state_dict())
    ranks = worker.spawn(dict(kind="split_steps", mesh="1x2", cases=cases),
                         tmp_path_factory.mktemp("tp_bf16"))
    single = worker.split_step(cases["tp"], port_mesh.SINGLE)
    single_unet = worker.split_step(cases["unet"], port_mesh.SINGLE)
    f32 = worker.split_step(dict(cases["tp"], compute_dtype=None), port_mesh.SINGLE)
    task = JaxAutoTask(JaxFno2d(in_chan=2, out_chan=2, n_case_params=5, **FNO_WIDTHS),
                       jax_loss_name_to_fn("nmse"), compute_dtype=jnp.bfloat16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grads, (scores, _) = jax.jit(jax.grad(
        lambda p: task.loss_scores(p, jbatch, train=True), has_aux=True))(
        params_to_flax(model.state_dict()))
    jax_result = dict(loss=float(scores["nmse"]), grads=params_from_flax(jax.device_get(grads)))
    return ranks, dict(single, unet=single_unet), f32, jax_result


def grad_error(got, want):
    return max((got[k] - w).abs().max().item() for k, w in want.items()) / max(
        w.abs().max().item() for w in want.values())


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_fno_bf16_split_step_matches_one_process(bf16_steps, name):
    """The bfloat16 step with the FNO split (tp) or staged (pp) over two
    model ranks against one process's bfloat16 step: the loss and every
    gradient; the ranks' parameters after the step equal; bfloat16 ran (the
    predictions are bfloat16, and one process's bfloat16 gradients are off
    its float32 ones)."""
    ranks, single, f32, _ = bf16_steps
    want = single["scores"][0]["nmse"]
    for result in ranks:
        got = result[name]
        assert got["preds"].dtype == torch.bfloat16
        assert math.isclose(got["scores"][0]["nmse"], want, rel_tol=BF16_LOSS_RTOL)
        assert grad_error(got["grads"], single["grads"]) <= BF16_GRAD_RTOL
        for k, p in got["params"].items():
            assert torch.equal(p, ranks[0][name]["params"][k]), k
    assert grad_error(single["grads"], f32["grads"]) > SEPARATION


def test_unet_bf16_tp_step_equals_one_process(bf16_steps):
    """The U-Net's bfloat16 step with its split weights gathered at use, on
    the bfloat16 copies that ``cast_call`` puts in their place: the loss and
    every gradient of one process's bfloat16 step, exactly (the gathered
    copies are the whole copies); each rank holds its slices."""
    ranks, single, _, _ = bf16_steps
    want = single["unet"]
    for result in ranks:
        got = result["unet"]
        assert got["preds"].dtype == torch.bfloat16
        assert got["scores"][0]["nmse"] == want["scores"][0]["nmse"]
        assert grad_error(got["grads"], want["grads"]) == 0.0
        assert got["local_params"] < got["whole_params"]


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_fno_bf16_split_step_matches_jax(bf16_steps, name):
    """The same steps against JAX's bfloat16 loss and gradients on one
    device, at the FNO's bounds in ``test_torch_mixed_precision.py``."""
    ranks, _, _, want = bf16_steps
    _, loss_rtol, grad_rtol = MP_TOLS["fno"]
    for result in ranks:
        got = result[name]
        assert math.isclose(got["scores"][0]["nmse"], want["loss"], rel_tol=loss_rtol)
        assert grad_error(got["grads"], want["grads"]) <= grad_rtol
