"""Serving pixel diffusion: the port's ``torch.export`` artifact
(``utils/export.py``) against the JAX package's ``jax.export`` one, and
the sampler as one loop operator in the served graph.

The same weights (the port's init carried to flax by
``utils/flax_import.py``) go through both packages' exports on the CPU,
and JAX's sampler draws from ``PRNGKey(0)``
(``tests/test_torch_diffusion.py::jax_ddpm_noise``) are the port's noise
input; JAX's exported rollout repeats them at every step. Predict within
1e-5 of max |frame|, a 2-step rollout within 1e-4 of its largest value.
Served without noise, the artifact draws what the in-process call draws:
within 1e-6 of ``predict_frame`` and of the stochastic
``make_rollout_fn``. The latent models are in
``tests/test_torch_serving_diffusion_latent.py`` and ``_lite.py``; pixel
diffusion served on a card in ``tests/test_torch_kernels.py``, which
imports no JAX.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfdbench_tpu.utils import export as jax_export
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_gencast, init_pixel_diffusion
from cfdbench_tpu_torch.parallel.mesh import DataMesh
from cfdbench_tpu_torch.training.rollout import make_rollout_fn
from cfdbench_tpu_torch.utils.export import (
    export_predict, export_rollout, graph_stats, load_exported,
)
from cfdbench_tpu_torch.utils.rng import EVAL_KEY
from tests.test_torch_diffusion import SAMPLE_RTOL, both_tasks, jax_ddpm_noise, t, task_batch

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)

B, P, STEPS, INFERENCE_STEPS = 2, 5, 2, 3
ROLLOUT_RTOL = 1e-4  # over the rollout's largest value
SERVED_ATOL = 1e-6  # served against in process: the same ops on the same draws
SMALL_FLAGS = ["--pixel_diffusion_base_channels", "8", "--pixel_diffusion_channel_mults", "1",
               "2", "--pixel_diffusion_num_res_blocks", "1"]


def jax_noise(task, frame_shape, steps=None):
    """JAX's sampler draws from ``PRNGKey(0)`` as the port's noise input:
    ``(S + 1, *sample)``, repeated ``steps`` times for a rollout, as JAX's
    exported rollout draws them."""
    shape = task.sample_shape(frame_shape)
    noise = torch.stack([jax_ddpm_noise(EVAL_KEY, i, shape, "cpu")
                         for i in range(task.num_inference_steps + 1)])
    return noise if steps is None else noise.expand(steps, *noise.shape).contiguous()


def serve_both(tmp_path, port, jax_task, params, host):
    """Each package's predict and ``STEPS``-step rollout, exported and
    served on the CPU: ``{kind: (port's artifact, JAX's output)}``."""
    H, W = host["inputs"].shape[1:3]
    args = (host["inputs"], host["case_params"], host["mask"])
    port.model.train()
    export_predict(port, tmp_path / "p.pt2", B, H, W, P, device="cpu")
    export_rollout(port, tmp_path / "r.pt2", B, H, W, P, steps=STEPS, device="cpu")
    assert port.model.training
    port.model.eval()
    jax_export.export_predict(jax_task, params, tmp_path / "p.stablehlo", B, H, W, P)
    jax_export.export_rollout(jax_task, params, tmp_path / "r.stablehlo", B, H, W, P,
                              steps=STEPS)
    return {kind: (load_exported(tmp_path / f"{kind[0]}.pt2"),
                   np.asarray(jax_export.load_exported(tmp_path / f"{kind[0]}.stablehlo")(*args)))
            for kind in ("predict", "rollout")}


def check_served(port, host, served):
    """Served with JAX's draws against JAX's artifacts, and without noise
    against the in-process calls."""
    args = tuple(t(host[k]) for k in ("inputs", "case_params", "mask"))
    frame_shape = args[0].shape
    (predict, want_p), (rollout, want_r) = served["predict"], served["rollout"]
    with torch.inference_mode():
        got_p = predict(*args, noise=jax_noise(port, frame_shape)).numpy()
        got_r = rollout(*args, noise=jax_noise(port, frame_shape, STEPS)).numpy()
        live_p, live_r = (predict(*args), port.predict_frame(*args)), (
            rollout(*args), make_rollout_fn(port.predict_frame, STEPS, stochastic=True)(*args))
    assert got_p.shape == want_p.shape == frame_shape
    assert got_r.shape == want_r.shape == (STEPS, *frame_shape)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=SAMPLE_RTOL * np.abs(want_p).max())
    assert np.abs(got_r - want_r).max() <= ROLLOUT_RTOL * np.abs(want_r).max()
    for got, want in (live_p, live_r):
        assert got.shape == want.shape and (got - want).abs().max().item() <= SERVED_ATOL


@pytest.fixture(scope="module")
def pixel(tmp_path_factory):
    """Pixel diffusion at base 8 in both packages, 3 inference steps, and
    both packages' artifacts at 16x16."""
    port, jax_task, params = both_tasks("pixel")
    port.num_inference_steps = jax_task.num_inference_steps = INFERENCE_STEPS
    host = task_batch(np.random.default_rng(0), B=B)
    return port, host, serve_both(tmp_path_factory.mktemp("pixel"), port, jax_task, params, host)


def test_served_pixel_diffusion_matches_jax_and_in_process(pixel):
    check_served(*pixel)


def test_sampler_is_one_loop_in_the_graph(pixel, tmp_path):
    """The sampler is one scan in the predict's graph, and one inside the
    rollout's loop over the frames; the graph's nodes, those of the loops'
    graphs included, do not grow with the inference steps."""
    port, host, served = pixel
    H, W = host["inputs"].shape[1:3]
    stats = {kind: graph_stats(served[kind][0].program) for kind in served}
    assert stats["predict"]["loops"] == [1] and stats["rollout"]["loops"] == [1, 1]
    port.num_inference_steps = 2 * INFERENCE_STEPS
    try:
        export_predict(port, tmp_path / "p6.pt2", B, H, W, P, device="cpu")
        export_rollout(port, tmp_path / "r6.pt2", B, H, W, P, steps=STEPS, device="cpu")
    finally:
        port.num_inference_steps = INFERENCE_STEPS
    for kind in served:
        six = load_exported(tmp_path / f"{kind[0]}6.pt2")
        assert six.sampler["steps"] == 2 * INFERENCE_STEPS
        assert graph_stats(six.program) == stats[kind]


def test_served_noise_of_another_shape_or_device_raises(pixel):
    port, host, served = pixel
    args = tuple(t(host[k]) for k in ("inputs", "case_params", "mask"))
    predict, rollout = served["predict"][0], served["rollout"][0]
    assert predict.sampler == dict(kind="predict", steps=INFERENCE_STEPS,
                                   noise_shape=[INFERENCE_STEPS + 1, B, 16, 16, 2])
    assert rollout.input_shapes[-1] == (STEPS, INFERENCE_STEPS + 1, B, 16, 16, 2)
    noise = predict.draw_noise()
    with pytest.raises(ValueError, match=r"noise is \(3, 2, 16, 16, 2\); the artifact's sampler"):
        predict(*args, noise=noise[1:])
    with pytest.raises(ValueError, match="noise is"):
        rollout(*args, noise=noise)
    with pytest.raises(ValueError, match="noise is on meta; the artifact runs on cpu"):
        predict(*args, noise=torch.empty(noise.shape, device="meta"))


def test_gencast_export_is_refused_by_name(tmp_path):
    """GenCast generates from two frames and has no predict_frame, in the
    JAX package either, whose export cannot take it."""
    args = Args.parse_args(["--model", "gencast", *SMALL_FLAGS])
    task = init_gencast(args, dict(residual_mean=[0.0, 0.0], residual_std=[1.0, 1.0]), P,
                        device="cpu")
    with pytest.raises(ValueError, match="GenCastCfdModel has no predict_frame"):
        export_predict(task, tmp_path / "p.pt2", B, 16, 16, P, device="cpu")
    with pytest.raises(ValueError, match="GenCastCfdModel has no predict_frame"):
        export_rollout(task, tmp_path / "r.pt2", B, 16, 16, P, device="cpu")
    assert not list(tmp_path.iterdir())


def test_export_of_a_task_on_a_mesh_is_refused(tmp_path):
    """An exported program is one device's: a task whose draws and scores
    span ranks (``use_mesh``) is refused, naming why."""
    task = init_pixel_diffusion(Args.parse_args(["--model", "pixel_diffusion", *SMALL_FLAGS]),
                                P, device="cpu")
    task.mesh = DataMesh(size=2, rank=0)
    with pytest.raises(ValueError, match="runs on a mesh of 2 ranks: an exported program is one"):
        export_predict(task, tmp_path / "p.pt2", B, 16, 16, P, device="cpu")


def test_serve_bench_selftest_serves_pixel_diffusion():
    """``serve_bench_torch.py --selftest --model pixel_diffusion`` at its
    default widths on the CPU: the served predict and rollout within
    SERVED_ATOL of in process, the noise draw timed apart, the sampler one
    loop, no FNO kernel."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import serve_bench_torch
    finally:
        sys.path.remove(str(REPO / "scripts"))
    result = serve_bench_torch.main(
        ["--selftest", "--device", "cpu", "--model", "pixel_diffusion", "--batch", "1",
         "--grid", "8", "--inference_steps", "2", "--steps", "2", "--iters", "1",
         "--warmup", "0"])["selftest"]
    assert result["config"]["model"] == "pixel_diffusion"
    for kind, loops in (("predict", [1]), ("rollout", [1, 1])):
        sec = result[kind]
        assert sec["loops"] == loops and sec["nodes"] > 0
        assert sec["in_shapes"][-1] == ((2, 3, 1, 8, 8, 2) if kind == "rollout" else
                                        (3, 1, 8, 8, 2))
        assert sec["max_abs_diff_vs_in_process"] <= SERVED_ATOL
        assert sec["launches_per_call"] == {"fno_block": 0, "fno_head": 0}
        assert sec["noise_draw_ms"] > 0 and sec["noise_draw_device_ms"] is None
        assert sec["weights_bytes"] < sec["bytes"]
