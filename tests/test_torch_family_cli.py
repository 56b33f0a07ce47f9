"""The conv and point families through both entry points against the
JAX package, end to end on the same weights and data: ``main_auto
--mode train_test`` (U-Net, AutoDeepONet) and ``main_multistep`` (U-Net,
ResNet with its ``include_initial`` alignment, AutoDeepONet with its
1-channel feedback), per-step numbers within rel 1e-4."""

import json

import jax
import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_auto as jax_main_auto
from cfdbench_tpu.cli import main_multistep as jax_main_multistep
from cfdbench_tpu.training.checkpoints import save_params as jax_save_params
from cfdbench_tpu.utils.artifacts import dump_json
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_auto_model
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.utils.flax_import import batch_stats_to_flax, params_to_flax
from tests.test_torch_multistep import assert_metrics_close
from tests.test_torch_train import (  # noqa: F401  (port_tree is a fixture)
    assert_close_rel,
    family_argv,
    family_run,
    port_tree,
    result_files,
)

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)


@pytest.mark.parametrize(
    "model,lr",
    [
        # BatchNorm leaves some parameters with gradients that are rounding
        # noise (the conv biases before it, weights on channels its mean
        # removes); Adam's first steps turn noise into +-lr steps, of
        # either sign in either package, and the losses drift apart in
        # proportion to lr, past 1e-4 within these 14 steps at the
        # default 1e-4 (ROADMAP.md C). The golden trajectory test bounds
        # that growth itself.
        ("unet", "1e-5"),
        ("auto_deeponet", "1e-4"),
    ],
)
def test_main_auto_family_matches_jax_end_to_end(port_tree, tmp_path, monkeypatch, model, lr):
    """--mode train_test, 2 epochs, from the weights the port's CLI draws
    (handed to the JAX trainer in place of its own init): the JAX
    main_auto's file set, its per-step train losses, dev losses, test
    scores and predictions (eval mode: the U-Net's on its running
    statistics)."""
    from cfdbench_tpu.training import trainer_auto as jax_trainer
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.utils.flax_import import batch_stats_to_flax

    argv = family_argv(model, port_tree, 2) + ["--mode", "train_test", "--lr", lr]
    start = init_auto_model(Args.parse_args(argv), n_case_params=5,
                            field_shape=(16, 16)).state_dict()
    params, stats = params_to_flax(start), batch_stats_to_flax(start)
    monkeypatch.setattr(jax_trainer.AutoTask, "init_variables", lambda self, rng, sample: (
        params, {"batch_stats": stats} if stats else {}))
    jax_main_auto(argv + ["--output_dir", str(tmp_path / "jax")])
    cli.main_auto(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")

    want_run = family_run(argv + ["--output_dir", str(tmp_path / "jax")])
    got_run = family_run(argv + ["--output_dir", str(tmp_path / "port")])
    files = result_files(got_run)
    assert files == result_files(want_run)
    assert {"ckpt-1/model.pt", "training_state/model.pt", "test/preds.npy"} <= files
    load = lambda run, name: json.loads((run / name).read_text())  # noqa: E731
    assert_close_rel(load(got_run, "train_losses.json"), load(want_run, "train_losses.json"),
                     "train losses")
    for ep in (0, 1):
        assert_close_rel([load(got_run, f"ckpt-{ep}/scores.json")["dev_loss"]],
                         [load(want_run, f"ckpt-{ep}/scores.json")["dev_loss"]], f"dev loss {ep}")
    got, want = load(got_run, "test/scores.json"), load(want_run, "test/scores.json")
    assert_close_rel(list(got["mean"].values()), list(want["mean"].values()), "test scores")
    got_preds, want_preds = (np.load(r / "test/preds.npy") for r in (got_run, want_run))
    assert got_preds.shape == want_preds.shape == (got_preds.shape[0], 16, 16,
                                                  1 if model.startswith("auto") else 2)
    np.testing.assert_allclose(got_preds, want_preds, rtol=0, atol=1e-4)


def seeded_weights(argv, rng):
    """The port's init for these flags, the U-Net's running statistics
    set off their init values, and the same weights as flax trees."""
    model = init_auto_model(Args.parse_args(argv), n_case_params=5, field_shape=(16, 16))
    with torch.no_grad():
        for k, buf in model.named_buffers():
            if k.endswith(("running_mean", "running_var")):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, buf.shape).astype(np.float32)))
    sd = model.state_dict()
    return sd, params_to_flax(sd), batch_stats_to_flax(sd)


@pytest.mark.parametrize("model", ["unet", "resnet", "auto_deeponet"])
def test_main_multistep_family_matches_jax_end_to_end(synth_root, tmp_path, rng, model):
    """One checkpoint in both layouts, rolled out by both packages: 20
    per-step metrics within rel 1e-4. The ResNet's first frame is the
    initial one in both; the point model feeds back its u frame."""
    argv = family_argv(model, synth_root, 1) + ["--output_dir", str(tmp_path)]
    run = family_run(argv)
    sd, params, stats = seeded_weights(argv, rng)
    jax_save_params({"params": params, **({"batch_stats": stats} if stats else {})},
                    run / "ckpt-0")
    ckpt.save_checkpoint(sd, run / "ckpt-0", ep=0, dev_loss=0.0)
    dump_json(dict(ep=0, train_loss=0.0, dev_loss=0.0, time=0.0), run / "ckpt-0" / "scores.json")
    out = run / "multistep_metrics.json"
    jax_main_multistep(argv)
    want = json.loads(out.read_text())
    out.unlink()
    cli.main_multistep(argv, device="cpu")
    got = json.loads(out.read_text())
    assert len(got) == 20
    assert_metrics_close(got, want)
    if model == "resnet":  # include_initial: step 1 scores the initial frame
        assert got[0]["mse"] == pytest.approx(0.0, abs=1e-12)
