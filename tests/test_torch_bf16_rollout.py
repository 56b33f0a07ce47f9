"""``main_multistep --rollout_dtype bfloat16`` in the port against the JAX
package: one checkpoint in both layouts, rolled out 20 steps by both
packages in bfloat16 (weights, running statistics, frame, case parameters
and mask cast once; the carried frames bfloat16), the frames and the
per-step metrics; the combinations that the JAX entry point prints and
drops, or never reads, refused by name.

Each test shows that bfloat16 ran: the port's frames are
``torch.bfloat16``, and off its own float32 rollout's by more than 1e-3 of
their max."""

import json

import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_multistep as jax_main_multistep
from cfdbench_tpu.training import rollout as jax_rollout
from cfdbench_tpu.training.checkpoints import save_params as jax_save_params
from cfdbench_tpu.utils.artifacts import dump_json
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.training.rollout import unroll
from tests.test_torch_family_cli import seeded_weights
from tests.test_torch_multistep import MODEL_FLAGS
from tests.test_torch_train import family_run, train_argv

torch.set_num_threads(1)

SEPARATION = 1e-3
FLAGS = {
    "fno": MODEL_FLAGS,
    "unet": ["--model", "unet", "--unet_dim", "4"],
    "resnet": ["--model", "resnet", "--resnet_hidden_chan", "8", "--resnet_depth", "1"],
    "ffno": ["--model", "ffno", "--fno_depth", "2", "--fno_hidden_dim", "8",
             "--fno_modes_x", "4", "--fno_modes_y", "4"],
    "auto_deeponet": ["--model", "auto_deeponet", "--deeponet_width", "16",
                      "--branch_depth", "2", "--trunk_depth", "2"],
    "auto_ffn": ["--model", "auto_ffn", "--autoffn_width", "16", "--autoffn_depth", "2"],
    "auto_edeeponet": ["--model", "auto_edeeponet", "--autoedeeponet_width", "16",
                       "--autoedeeponet_depth", "2"],
}
# JAX vs the port, each in bfloat16, over the 20 steps: the frames (of
# their max) and the per-step metrics (each metric's largest difference
# over its largest value). Measured on the CPU: the FNO 1.47e-2, 2.3e-4;
# the U-Net 0 (the same bfloat16 frames), 3.9e-7; the ResNet 1.84e-2,
# 2.7e-4; the FFNO 9.2e-3, 6.0e-5; the Auto-DeepONet 1.58e-2, 1.7e-3; the
# Auto-FFN 0 (it runs float32 on the bfloat16-rounded weights in both, and
# carries bfloat16 frames), 1.0e-6; the Auto-EDeepONet 1.94e-2, 1.25e-3.
# Each bound is at most 4x its measurement and at most 5e-2.
TOLS = {
    "fno": (5e-2, 9e-4),
    "unet": (0.0, 1.5e-6),
    "resnet": (5e-2, 1e-3),
    "ffno": (3.6e-2, 2.4e-4),
    "auto_deeponet": (5e-2, 6.8e-3),
    "auto_ffn": (0.0, 4e-6),
    "auto_edeeponet": (5e-2, 5e-3),
}


def argv_for(model, data_root, out):
    return FLAGS[model] + train_argv(data_root, 1)[len(MODEL_FLAGS):] + [
        "--output_dir", str(out)]


def write_checkpoint(argv, rng):
    """One checkpoint of seeded weights (a U-Net's running statistics off
    their init) in both packages' layouts, under the run's ckpt-0."""
    run = family_run(argv)
    sd, params, stats = seeded_weights(argv, rng)
    jax_save_params({"params": params, **({"batch_stats": stats} if stats else {})},
                    run / "ckpt-0")
    ckpt.save_checkpoint(sd, run / "ckpt-0", ep=0, dev_loss=0.0)
    dump_json(dict(ep=0, train_loss=0.0, dev_loss=0.0, time=0.0), run / "ckpt-0" / "scores.json")
    return run


@pytest.mark.parametrize("model", list(FLAGS))
def test_bf16_rollout_matches_jax(synth_root, tmp_path, rng, monkeypatch, model):
    """Both packages' ``main_multistep --rollout_dtype bfloat16`` on one
    checkpoint: the 20 frames (the JAX ones as its metrics receive them,
    widened to float32) and the 20 per-step metrics at the bounds of
    ``TOLS``; the port's frames are bfloat16, finite, and off its float32
    rollout's."""
    argv = argv_for(model, synth_root, tmp_path)
    run = write_checkpoint(argv, rng)
    out = run / "multistep_metrics.json"
    seen = []
    metrics = jax_rollout.multistep_metrics

    def keep(preds, *args, **kwargs):
        seen.append(np.asarray(preds, np.float32))
        return metrics(preds, *args, **kwargs)

    monkeypatch.setattr(jax_rollout, "multistep_metrics", keep)
    bf16 = ["--rollout_dtype", "bfloat16"]
    jax_main_multistep(argv + bf16)
    want_frames, want = seen[0], json.loads(out.read_text())
    got_frames = cli.main_multistep(argv + bf16, device="cpu")
    got = json.loads(out.read_text())
    f32_frames = cli.main_multistep(argv, device="cpu").numpy()

    assert got_frames.dtype == torch.bfloat16
    got_frames = got_frames.float().numpy()
    assert got_frames.shape == want_frames.shape == f32_frames.shape
    assert np.isfinite(got_frames).all()
    assert np.abs(got_frames - f32_frames).max() > SEPARATION * np.abs(f32_frames).max()
    frame_tol, metric_tol = TOLS[model]
    assert np.abs(got_frames - want_frames).max() <= frame_tol * np.abs(want_frames).max()
    assert len(got) == len(want) == 20
    for k in want[0]:
        top = max(abs(w[k]) for w in want)
        assert max(abs(g[k] - w[k]) for g, w in zip(got, want)) <= metric_tol * top, k


@pytest.mark.parametrize("flags,what", [
    (["--model", "pixel_diffusion"], "--model pixel_diffusion: the JAX main_multistep prints"),
    (["--model", "latent_diffusion2"], "--model latent_diffusion2: the JAX main_multistep prints"),
    (["--model", "gencast"], "--model gencast: the JAX main_multistep ignores it"),
    (["--model", "ffn"], "--model ffn: the JAX main_multistep ignores it"),
    (["--model", "deeponet"], "--model deeponet: the JAX main_multistep ignores it"),
    (MODEL_FLAGS + ["--use_pallas_head", "1"], "--use_pallas_head 1: the JAX main_multistep prints"),
])
def test_bf16_rollout_refuses_what_jax_drops(tmp_path, flags, what):
    """Each combination that the JAX main_multistep prints and runs in
    float32, or whose branch never reads the flag, raises by name before
    anything is read or written."""
    argv = flags + ["--data_dir", str(tmp_path / "data"), "--output_dir", str(tmp_path / "out"),
                    "--rollout_dtype", "bfloat16"]
    with pytest.raises(NotImplementedError, match=f"--rollout_dtype bfloat16 with {what}.*"
                                                  r"\(ROADMAP.md C\)"):
        cli.main_multistep(argv, device="cpu")
    assert not (tmp_path / "out").exists()


def test_bf16_rollout_flag_takes_two_values(tmp_path):
    argv = MODEL_FLAGS + ["--data_dir", str(tmp_path), "--rollout_dtype", "float16"]
    with pytest.raises(ValueError, match="choose float32 or bfloat16"):
        cli.main_multistep(argv, device="cpu")
    # The pallas head alone, and the other models with it, are taken.
    for flags in (MODEL_FLAGS + ["--use_pallas_head", "1"],
                  ["--model", "unet", "--use_pallas_head", "1", "--rollout_dtype", "bfloat16"]):
        cli.check_rollout_flags(Args.parse_args(flags))


def test_unroll_carries_the_first_frame_dtype():
    """A step that returns float32 from a bfloat16 frame (the point models,
    the FFNO) is carried, and stacked, in bfloat16, as the JAX scan
    carries it; with include_initial the first frame leads."""
    seen = []

    def step(frame, case_params, mask, i):
        seen.append(frame.dtype)
        return frame.float() * 2 + i

    frame0 = torch.ones(2, 3, 3, 1, dtype=torch.bfloat16)
    frames = unroll(step, frame0, None, None, 4, include_initial=True)
    assert frames.dtype == torch.bfloat16 and frames.shape == (4, 2, 3, 3, 1)
    assert seen == [torch.bfloat16] * 3
    assert frames[:, 0, 0, 0, 0].tolist() == [1.0, 2.0, 5.0, 12.0]
