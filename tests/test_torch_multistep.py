"""The port's inference slice against the JAX package: rollout and
per-step metrics on the same weights and arrays, ``main_multistep`` end
to end on one checkpoint, the checkpoint export, the CLI's refusals, and
``chip_smoke.py``'s refusal to run without a card."""

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cfdbench_tpu.cli import main_multistep as jax_main_multistep
from cfdbench_tpu.config import Args
from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.training import rollout as jax_rollout
from cfdbench_tpu.training.checkpoints import save_params as jax_save_params
from cfdbench_tpu.utils.artifacts import dump_json, get_output_dir
from cfdbench_tpu_torch.cli import main_multistep
from cfdbench_tpu_torch.models.fno import Fno2d
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.training import rollout
from cfdbench_tpu_torch.utils.flax_import import params_from_flax

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MODEL_FLAGS = [
    "--model", "fno", "--fno_depth", "2", "--fno_hidden_dim", "8",
    "--fno_modes_x", "4", "--fno_modes_y", "4",
]
METRIC_RTOL = 1e-4


def jax_fno():
    return JaxFno2d(in_chan=2, out_chan=2, n_case_params=5, num_layers=2,
                    modes1=4, modes2=4, hidden_dim=8)


def jax_params(H=16, W=16, seed=0):
    sample = (np.zeros((1, H, W, 2), np.float32), np.zeros((1, 5), np.float32),
              np.ones((1, H, W, 1), np.float32))
    return jax_fno().init(jax.random.PRNGKey(seed), *sample)["params"]


def port_fno(params):
    model = Fno2d(in_chan=2, out_chan=2, n_case_params=5, num_layers=2,
                  modes1=4, modes2=4, hidden_dim=8,
                  generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model.eval()


def assert_metrics_close(got, want):
    assert len(got) == len(want)
    for s, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"mse", "nmse", "mae"}
        for k in g:
            assert math.isclose(g[k], w[k], rel_tol=METRIC_RTOL), (s, k, g[k], w[k])


def test_rollout_and_metrics_match_jax(rng):
    B, H, W, S = 3, 16, 16, 20
    params = jax_params(H, W)
    frame0 = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    cp = rng.standard_normal((B, 5)).astype(np.float32)
    mask = np.ones((B, H, W, 1), np.float32)
    mask[:, 3:6, 4:9] = 0
    labels = rng.standard_normal((B, S, H, W, 3)).astype(np.float32)
    # The last case repeats the second, as device padding would: weight 0.
    frame0[2], cp[2], mask[2], labels[2] = frame0[1], cp[1], mask[1], labels[1]
    weights = np.array([1.0, 1.0, 0.0], np.float32)

    model = jax_fno()
    jax_roll = jax_rollout.make_rollout_fn(
        lambda p, f, c, m: model.apply({"params": p}, f, c, m), steps=S
    )
    want_frames = jax_roll(params, frame0, cp, mask)
    port_roll = rollout.make_rollout_fn(port_fno(params), steps=S)
    got_frames = port_roll(*(torch.from_numpy(a) for a in (frame0, cp, mask)))
    assert got_frames.shape == (S, B, H, W, 2)
    np.testing.assert_allclose(got_frames.numpy(), np.asarray(want_frames), atol=1e-4)

    got = rollout.multistep_metrics(got_frames, labels, mask, case_weights=weights)
    assert_metrics_close(
        got, jax_rollout.multistep_metrics(want_frames, labels, mask, case_weights=weights)
    )
    # Weighted out: equal to the metrics of the two real cases alone.
    assert_metrics_close(got, rollout.multistep_metrics(got_frames[:, :2], labels[:2], mask[:2]))


def test_rollout_include_initial_drops_last_prediction():
    calls = []

    def step(f, c, m):
        calls.append(1)
        return f + 1

    frames = rollout.make_rollout_fn(step, steps=4, include_initial=True)(
        torch.zeros(2, 3), None, None
    )
    assert len(calls) == 3
    assert frames[:, 0, 0].tolist() == [0.0, 1.0, 2.0, 3.0]


def write_jax_run(root: Path, data_root: Path):
    """A JAX checkpoint (params + scores.json) in the run dir of the
    tiny FNO; returns (run_dir, params, argv)."""
    argv = MODEL_FLAGS + [
        "--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
        "--output_dir", str(root), "--mesh_shape", "1",
    ]
    run_dir = get_output_dir(Args.parse_args(argv), is_auto=True)
    params = jax_params()
    jax_save_params({"params": params}, run_dir / "ckpt-0")
    dump_json(dict(ep=0, train_loss=0.0, dev_loss=0.0, time=0.0),
              run_dir / "ckpt-0" / "scores.json")
    return run_dir, params, argv


def test_main_multistep_matches_jax_end_to_end(synth_root, tmp_path):
    run_dir, params, argv = write_jax_run(tmp_path, synth_root)
    ckpt.save_params(params_from_flax(jax.device_get(params)), run_dir / "ckpt-0")
    out = run_dir / "multistep_metrics.json"

    jax_main_multistep(argv)
    want = json.loads(out.read_text())
    out.unlink()
    main_multistep(argv, device="cpu")
    got = json.loads(out.read_text())
    assert len(got) == 20 and all(math.isfinite(v) for m in got for v in m.values())
    assert_metrics_close(got, want)


def test_export_torch_checkpoint(synth_root, tmp_path):
    run_dir, params, argv = write_jax_run(tmp_path, synth_root)
    with pytest.raises(FileNotFoundError, match="export_torch_checkpoint"):
        ckpt.load_best_params(run_dir)

    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", REPO / "scripts" / "export_torch_checkpoint.py"
    )
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    path = script.main(argv)
    assert path == run_dir / "ckpt-0" / "model.pt"
    sd = ckpt.load_best_params(run_dir)
    want = params_from_flax(jax.device_get(params))
    assert sd.keys() == want.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)


def test_export_torch_checkpoint_carries_batch_stats(synth_root, tmp_path, rng):
    """A JAX U-Net checkpoint: its BatchNorm statistics become the port's
    buffers, and the file loads into the port's model."""
    from cfdbench_tpu.models.unet import UNet as JaxUNet
    from cfdbench_tpu_torch.config import Args as PortArgs
    from cfdbench_tpu_torch.models import init_auto_model

    argv = ["--model", "unet", "--unet_dim", "4", "--data_name", "cavity_prop_bc_geo",
            "--data_dir", str(synth_root), "--output_dir", str(tmp_path), "--mesh_shape", "1"]
    run_dir = get_output_dir(Args.parse_args(argv), is_auto=True)
    variables = jax.eval_shape(lambda: JaxUNet(dim=4).init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 2), np.float32),
        np.zeros((1, 5), np.float32), np.ones((1, 64, 64, 1), np.float32)))
    variables = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), variables)
    jax_save_params(variables, run_dir / "ckpt-0")
    dump_json(dict(ep=0, train_loss=0.0, dev_loss=0.0, time=0.0),
              run_dir / "ckpt-0" / "scores.json")
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", REPO / "scripts" / "export_torch_checkpoint.py"
    )
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main(argv)
    sd = ckpt.load_best_params(run_dir)
    want = params_from_flax(variables["params"], variables["batch_stats"])
    assert sd.keys() == want.keys()
    assert sum(k.endswith("running_var") for k in sd) == 18  # two BatchNorms a DoubleConv
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    model = init_auto_model(PortArgs.parse_args(argv), n_case_params=5)
    model.load_state_dict(sd)


def test_save_checkpoint_best_is_lowest_dev_loss(tmp_path):
    w = torch.arange(3.0)
    for ep, dev_loss in ((0, 0.5), (1, 0.2), (2, 0.9)):
        ckpt.save_checkpoint({"w": w + ep}, tmp_path / f"ckpt-{ep}", ep=ep,
                             dev_loss=dev_loss)
    assert ckpt.get_best_ckpt(tmp_path) == tmp_path / "ckpt-1"
    torch.testing.assert_close(ckpt.load_best_params(tmp_path)["w"], w + 1,
                               rtol=0, atol=0)


@pytest.mark.parametrize(
    "flags,error",
    [
        (["--rollout_dtype", "bfloat16"], "A6b"),
        (["--spectral_backend", "fft"], "A17"),
        (["--mesh_shape", "2x4"], "A15"),
        (["--compilation_cache_dir", "cache"], "A17"),
        (["--matmul_precision", "high"], "A17"),
        (["--profile_dir", "trace"], "A7"),
        (["--model", "latent_diffusion"], "A13"),
    ],
)
def test_cli_refuses_unported_flags(tmp_path, flags, error):
    argv = MODEL_FLAGS + ["--data_name", "cavity_prop_bc_geo",
                          "--data_dir", str(tmp_path)] + flags
    with pytest.raises(NotImplementedError, match=error):
        main_multistep(argv)


def test_auto_deeponet_cnn_rollout_raises_in_both_packages(synth_root, tmp_path):
    """The point models feed back 1-channel frames, which AutoDeepONetCnn's
    first conv, built on 2 + 1 + P channels, cannot take: the JAX
    main_multistep fails on the kernel's shape, the port refuses by name
    before reading anything."""
    from flax.errors import ScopeParamShapeError

    from cfdbench_tpu_torch.config import Args as PortArgs
    from cfdbench_tpu_torch.models import init_auto_model
    from cfdbench_tpu_torch.utils.flax_import import params_to_flax

    argv = ["--model", "auto_deeponet_cnn", "--data_name", "cavity_prop_bc_geo",
            "--data_dir", str(synth_root), "--output_dir", str(tmp_path), "--mesh_shape", "1"]
    run_dir = get_output_dir(Args.parse_args(argv), is_auto=True)
    sd = init_auto_model(PortArgs.parse_args(argv), n_case_params=5,
                         field_shape=(16, 16)).state_dict()
    jax_save_params({"params": params_to_flax(sd)}, run_dir / "ckpt-0")
    ckpt.save_params(sd, run_dir / "ckpt-0")
    dump_json(dict(ep=0, train_loss=0.0, dev_loss=0.0, time=0.0),
              run_dir / "ckpt-0" / "scores.json")
    with pytest.raises(ScopeParamShapeError,
                       match=r"expected .*\(5, 5, 7, 32\).* has shape \(5, 5, 8, 32\)"):
        jax_main_multistep(argv)
    with pytest.raises(ValueError, match="auto_deeponet_cnn has no rollout.*ROADMAP.md C"):
        main_multistep(argv, device="cpu")
    assert not (run_dir / "multistep_metrics.json").exists()


def test_main_multistep_needs_a_card_unless_told_cpu(synth_root, tmp_path, monkeypatch):
    # No silent fallback: with no device given, no card means an error,
    # before any data is read or anything is written.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run_dir, params, argv = write_jax_run(tmp_path, synth_root)
    ckpt.save_params(params_from_flax(jax.device_get(params)), run_dir / "ckpt-0")
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        main_multistep(argv)
    assert not (run_dir / "multistep_metrics.json").exists()
    main_multistep(argv, device="cpu")
    assert len(json.loads((run_dir / "multistep_metrics.json").read_text())) == 20


@pytest.mark.parametrize("flags,error", [
    (["--fno_hidden_dim", "160"], "fno_head at width 160"),
    (["--fno_modes_y", "9"], None),  # inside the limits: refused for want of a card only
])
def test_main_multistep_on_the_card_refuses_shapes_its_kernels_cannot_take(
        synth_root, tmp_path, monkeypatch, flags, error):
    # The kernels' limits, read from their CPU emulation, are checked on
    # the data's grid before the model is built or anything is written.
    from cfdbench_tpu_torch import cli
    from cfdbench_tpu_torch.ops import _build, fno_kernels

    try:
        lib = _build.load_emulation()
    except RuntimeError as e:  # no host C++ compiler
        pytest.skip(str(e))

    class PastTheCheck(Exception):
        pass

    def build_model(*args, **kwargs):
        raise PastTheCheck

    monkeypatch.setattr(fno_kernels, "load_library", lambda: lib)
    monkeypatch.setattr(cli, "init_auto_model", build_model)
    argv = MODEL_FLAGS + ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(synth_root),
                          "--output_dir", str(tmp_path)] + flags
    with pytest.raises(ValueError if error else PastTheCheck,
                       match=error and error + ".*ROADMAP.md B3"):
        main_multistep(argv, device="cuda")
    assert not list(tmp_path.rglob("multistep_metrics.json"))


def test_chip_smoke_refuses_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    # From the checkout, and alone in a directory with nothing else of it.
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert "needs a CUDA device" in proc.stderr
        assert '"ok"' not in proc.stdout
