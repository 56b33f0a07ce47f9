"""Serving: the port's ``torch.export`` artifacts (``utils/export.py``),
its export and benchmark scripts, and the FNO kernels' registered
operators.

The same weights (carried from flax by ``utils/flax_import.py``) and the
same numpy inputs go through the JAX package's ``jax.export`` artifacts
and the port's, both exported and served on the CPU: predict within
2e-5, a 3-step rollout within 1e-4 of its largest value. The port's
served output equals its in-process ``predict_frame``. On the CPU the
operators run their plain versions; ``tests/test_torch_kernels.py``
serves the FNO on a card.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cfdbench_tpu.config import Args as JaxArgs
from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_fn
from cfdbench_tpu.models import init_auto_model as jax_init_auto_model
from cfdbench_tpu.training.trainer_auto import AutoTask as JaxAutoTask
from cfdbench_tpu.utils import export as jax_export
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_auto_model
from cfdbench_tpu_torch.ops import _build
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.training.trainer_auto import AutoTask
from cfdbench_tpu_torch.utils.export import export_predict, export_rollout, load_exported
from cfdbench_tpu_torch.utils.flax_import import params_from_flax

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)

B, H, W, P = 4, 16, 16, 5
STEPS = 3
PREDICT_ATOL = 2e-5  # f32 forward parity, the JAX package's own bound
ROLLOUT_RTOL = 1e-4  # over the rollout's largest value
SERVED_ATOL = 1e-6  # served against in process, the same ops on the same inputs
FLAGS = {
    "fno": ["--model", "fno", "--fno_depth", "2", "--fno_hidden_dim", "8",
            "--fno_modes_x", "4", "--fno_modes_y", "4"],
    "unet": ["--model", "unet", "--unet_dim", "4"],
    "auto_deeponet": ["--model", "auto_deeponet", "--deeponet_width", "16",
                      "--branch_depth", "2", "--trunk_depth", "2"],
}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def inputs(rng, channels):
    mask = np.ones((B, H, W, 1), np.float32)
    mask[:, 4:8, 5:9] = 0
    return (rng.standard_normal((B, H, W, channels)).astype(np.float32),
            rng.standard_normal((B, P)).astype(np.float32), mask)


def both_models(name, rng):
    """The JAX task with its variables, and the port's task on the same
    weights; the U-Net's running statistics set off their init values."""
    jax_model = jax_init_auto_model(JaxArgs.parse_args(FLAGS[name]), n_case_params=P,
                                    field_shape=(H, W))
    # Jitted: one compile, not one dispatch per op (the U-Net's eager init
    # takes tens of seconds on the CPU).
    variables = jax.jit(lambda *a: jax_model.init(*a, train=False))(
        jax.random.PRNGKey(0), *map(np.asarray, inputs(rng, 2)))
    params = jax.device_get(variables["params"])
    stats = variables.get("batch_stats")
    if stats is not None:
        stats = jax.tree.map(lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
                             jax.device_get(stats))
    model = init_auto_model(Args.parse_args(FLAGS[name]), n_case_params=P, field_shape=(H, W),
                            generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(params, stats))
    state = {"batch_stats": stats} if stats is not None else None
    return JaxAutoTask(jax_model, jax_loss_fn("nmse")), params, state, AutoTask(model)


@pytest.mark.parametrize("name", list(FLAGS))
def test_served_artifacts_match_jax_artifacts(tmp_path, rng, name):
    """Predict and a 3-step rollout, exported and served by each package
    on the CPU, on the same weights and inputs; the port's served predict
    against its in-process one; the model's mode is restored."""
    jax_task, params, state, task = both_models(name, rng)
    frame, cp, mask = inputs(rng, task.feedback_channels)
    jax_export.export_predict(jax_task, params, tmp_path / "p.stablehlo", B, H, W, P,
                              model_state=state)
    jax_export.export_rollout(jax_task, params, tmp_path / "r.stablehlo", B, H, W, P,
                              steps=STEPS, model_state=state)
    want_p = np.asarray(jax_export.load_exported(tmp_path / "p.stablehlo")(frame, cp, mask))
    want_r = np.asarray(jax_export.load_exported(tmp_path / "r.stablehlo")(frame, cp, mask))

    task.model.train()
    assert export_predict(task, tmp_path / "p.pt2", B, H, W, P, device="cpu") > 0
    export_rollout(task, tmp_path / "r.pt2", B, H, W, P, steps=STEPS, device="cpu")
    assert task.model.training
    task.model.eval()
    args = (t(frame), t(cp), t(mask))
    with torch.inference_mode():
        got_p = load_exported(tmp_path / "p.pt2")(*args)
        got_r = load_exported(tmp_path / "r.pt2")(*args)
        live = task.predict_frame(*args)
    assert got_p.shape == want_p.shape and got_r.shape == want_r.shape == (STEPS, B, H, W,
                                                                           want_p.shape[-1])
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0, atol=PREDICT_ATOL)
    assert np.abs(got_r.numpy() - want_r).max() <= ROLLOUT_RTOL * np.abs(want_r).max()
    assert (got_p - live).abs().max().item() <= SERVED_ATOL


def small_fno_task():
    model = init_auto_model(Args.parse_args(FLAGS["fno"]), n_case_params=P, field_shape=(H, W),
                            generator=torch.Generator().manual_seed(0))
    return AutoTask(model.eval())


def test_served_fno_graph_holds_the_kernel_operators(tmp_path):
    """The rollout's graph: one block node a layer and step, one head
    node a step, the spectral conv inside them (no FFT node)."""
    export_rollout(small_fno_task(), tmp_path / "r.pt2", B, H, W, P, steps=STEPS, device="cpu")
    graph = load_exported(tmp_path / "r.pt2").program.graph
    targets = [n.target for n in graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.cfdbench_tpu_torch.fno_block.default) == 2 * STEPS
    assert targets.count(torch.ops.cfdbench_tpu_torch.fno_head.default) == STEPS
    assert not [x for x in targets if "fft" in str(x)]


@pytest.mark.parametrize("op", ["fno_block", "fno_head"])
def test_operators_pass_opcheck(rng, op):
    """Schema, fake (shapes, dtypes, dynamic shapes) and registration of
    both operators against their CPU kernels, the plain versions."""
    C, modes = 6, 3
    x = t(rng.standard_normal((2, 10, 9, C)))
    if op == "fno_block":
        args = (x, t(rng.standard_normal((2, 2, C, C, modes, modes))),
                t(rng.standard_normal((C, C))), t(rng.standard_normal(C)), modes, modes)
        torch.library.opcheck(fk.fno_block_op, args)
    else:
        args = (x, t(rng.standard_normal((16, C))), t(rng.standard_normal(16)),
                t(rng.standard_normal((2, 16))), t(rng.standard_normal(2)),
                torch.ones((2, 10, 9, 1)))
        torch.library.opcheck(fk.fno_head_op, args)


@pytest.mark.parametrize("grid,hidden,modes,what", [
    ((2, 512), 32, 12, None),  # a row of x past the resident inverse-columns pass: tiled
    ((16, 16), 160, 4, None),  # fc1's weights past shared memory: streamed
    ((16, 16), 32, 0, "fno_block at W=16, width 32, 0 modes along W"),  # no FNO has it
])
def test_export_refuses_a_shape_the_kernels_cannot_take(tmp_path, monkeypatch, grid, hidden,
                                                        modes, what):
    """With the kernels' CPU emulation as the CPU's library, the operators'
    fakes ask it for the shape when the program is exported: they take the
    shapes past the kernels' old shared-memory limits and refuse, naming
    it, only a size that is not positive; with the plain versions the CPU
    takes it."""
    try:
        lib = _build.load_emulation()
    except RuntimeError as e:  # no host C++ compiler
        pytest.skip(str(e))
    model = init_auto_model(
        Args.parse_args(["--model", "fno", "--fno_depth", "1", "--fno_hidden_dim", str(hidden),
                         "--fno_modes_x", str(modes), "--fno_modes_y", str(modes)]),
        n_case_params=P, field_shape=grid, generator=torch.Generator().manual_seed(0))
    task = AutoTask(model)
    export_predict(task, tmp_path / "plain.pt2", 1, *grid, P, device="cpu")
    monkeypatch.setattr(fk, "kernel_library", lambda device: lib)
    if what is None:
        export_predict(task, tmp_path / "taken.pt2", 1, *grid, P, device="cpu")
        assert (tmp_path / "taken.pt2").exists()
        return
    with pytest.raises(ValueError, match="takes positive sizes") as e:
        export_predict(task, tmp_path / "refused.pt2", 1, *grid, P, device="cpu")
    assert str(e.value).startswith(what)
    assert not (tmp_path / "refused.pt2").exists()


def test_auto_deeponet_cnn_serves_predict_and_refuses_its_rollout(tmp_path, rng):
    """Its predict takes the 2-channel frame it was built on (the JAX
    export traces 1 channel and fails, ROADMAP.md C); its rollout is
    refused by name, as main_multistep's is."""
    grid = (32, 32)
    model = init_auto_model(Args(model="auto_deeponet_cnn"), n_case_params=P, field_shape=grid,
                            generator=torch.Generator().manual_seed(0))
    task = AutoTask(model.eval())
    with pytest.raises(ValueError, match="auto_deeponet_cnn has no rollout"):
        export_rollout(task, tmp_path / "r.pt2", 2, *grid, P, device="cpu")
    export_predict(task, tmp_path / "p.pt2", 2, *grid, P, device="cpu")
    args = (t(rng.standard_normal((2, *grid, 2))), t(rng.standard_normal((2, P))),
            torch.ones((2, *grid, 1)))
    with torch.inference_mode():
        got = load_exported(tmp_path / "p.pt2")(*args)
        assert got.shape == (2, *grid, 1)
        assert (got - task.predict_frame(*args)).abs().max().item() <= SERVED_ATOL


def test_artifact_runs_only_on_the_device_it_was_exported_for(tmp_path):
    export_predict(small_fno_task(), tmp_path / "p.pt2", B, H, W, P, device="cpu")
    with pytest.raises(ValueError, match="exported for cpu and runs there only"):
        load_exported(tmp_path / "p.pt2", device="cuda")
    served = load_exported(tmp_path / "p.pt2", device="cpu")
    assert served.input_shapes == [(B, H, W, 2), (B, P), (B, H, W, 1)]
    meta = [torch.empty(s, device="meta") for s in served.input_shapes]
    with pytest.raises(ValueError, match="frame is on meta; the artifact runs on cpu"):
        served(*meta)


@pytest.fixture(scope="module")
def trained_fno(tmp_path_factory):
    """A 16x16 cavity tree and an FNO the port's main_auto trained on it
    for one epoch, on the CPU."""
    from cfdbench_tpu_torch.cli import main_auto
    from cfdbench_tpu_torch.data.synthetic import generate_problem

    root = tmp_path_factory.mktemp("serve_tree")
    generate_problem(root / "data", "cavity", cases_per_subset=4, num_frames=12, grid=16, seed=0)
    argv = ["--model", "fno", "--data_name", "cavity_prop_bc_geo", "--data_dir",
            str(root / "data"), "--output_dir", str(root / "result"), "--fno_depth", "2",
            "--fno_hidden_dim", "8", "--fno_modes_x", "4", "--fno_modes_y", "4"]
    main_auto(argv + ["--mode", "train", "--num_epochs", "1", "--eval_interval", "1",
                      "--batch_size", "8"],
              device="cpu")
    return argv


def test_export_script_serves_what_main_multistep_rolls_out(trained_fno):
    """scripts/export_model_torch.py on the best checkpoint, at the test
    split's case count; the served rollout gives main_multistep's frames."""
    from cfdbench_tpu_torch.cli import main_multistep
    from cfdbench_tpu_torch.data import load_test_cases

    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import export_model_torch
    finally:
        sys.path.remove(str(REPO / "scripts"))
    features, case_params = load_test_cases(Args.parse_args(trained_fno), 20)
    n = features.shape[0]
    serve = export_model_torch.main(trained_fno + ["--batch_size", str(n), "--device", "cpu"])
    assert sorted(p.name for p in serve.iterdir()) == ["predict.pt2", "rollout.pt2"]
    want = main_multistep(trained_fno, device="cpu")
    with torch.inference_mode():
        got = load_exported(serve / "rollout.pt2")(
            t(features[:, 0, :, :, :2]), t(case_params), t(features[:, 0, :, :, 2:3]))
    assert got.shape == want.shape == (20, n, 16, 16, 2)
    assert (got - want).abs().max().item() <= SERVED_ATOL


def test_serve_bench_selftest_reports_served_and_in_process(capsys):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import serve_bench_torch
    finally:
        sys.path.remove(str(REPO / "scripts"))
    result = serve_bench_torch.main(
        ["--selftest", "--device", "cpu", "--batch", "2", "--grid", "16", "--hidden", "8",
         "--depth", "2", "--modes", "4", "--steps", "3", "--iters", "2"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(result))
    for kind, shape in (("predict", [2, 16, 16, 2]), ("rollout", [3, 2, 16, 16, 2])):
        sec = result["selftest"][kind]
        assert list(sec["out_shape"]) == shape and sec["in_shapes"][0] == (2, 16, 16, 2)
        assert sec["latency_ms_per_call"] > 0 and sec["frames_per_sec"] > 0
        assert sec["device_ms_per_call"] is None  # no card, no device time
        assert sec["max_abs_diff_vs_in_process"] <= SERVED_ATOL
        assert sec["launches_per_call"] == {"fno_block": 0, "fno_head": 0}  # plain versions
        assert isinstance(sec["served_overhead_pct"], float)
