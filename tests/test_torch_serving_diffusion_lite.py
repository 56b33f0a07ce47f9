"""Serving the Lite latent diffusion model (conditioning by addition)
against the JAX package's artifact, as
``tests/test_torch_serving_diffusion_latent.py`` holds v1 and v2, and
``scripts/export_model_torch.py`` on a latent run that ``main_auto``
trained: the served rollout of its best weights and its VAE gives
``main_multistep``'s frames.
"""

import sys
from pathlib import Path

import pytest
import torch

from cfdbench_tpu_torch.config import Args
from tests.test_torch_diffusion import t
from tests.test_torch_serving_diffusion_latent import check_vae_rides, serve_latent
from tests.test_torch_serving_diffusion_pixel import INFERENCE_STEPS, SERVED_ATOL, check_served

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lite(tmp_path_factory):
    return serve_latent("lite", tmp_path_factory)


def test_served_lite_matches_jax_and_in_process(lite):
    check_served(*lite)


def test_lite_artifact_carries_the_frozen_vae(lite):
    port, _, served = lite
    check_vae_rides(port, served)


@pytest.fixture(scope="module")
def trained_ldm(tmp_path_factory):
    """A 16x16 cavity tree, a lite VAE's weights where ``main_auto`` reads
    them, and a latent_diffusion2 run that main_auto trained on it for one
    epoch at UNet base 8, 3 inference steps, on the CPU."""
    from cfdbench_tpu_torch.cli import main_auto
    from cfdbench_tpu_torch.data.synthetic import generate_problem
    from cfdbench_tpu_torch.models import make_cfd_vae
    from cfdbench_tpu_torch.training.checkpoints import save_params

    root = tmp_path_factory.mktemp("ldm_tree")
    generate_problem(root / "data", "cavity", cases_per_subset=4, num_frames=12, grid=16, seed=0)
    vae = make_cfd_vae("lite", generator=torch.Generator().manual_seed(5))
    save_params(vae.state_dict(), root / "vae")
    argv = ["--model", "latent_diffusion2", "--data_name", "cavity_prop_bc_geo", "--data_dir",
            str(root / "data"), "--output_dir", str(root / "result"), "--ldm_vae_weights_path",
            str(root / "vae"), "--unet_base_channels", "8", "--unet_channel_mult", "1", "2",
            "--ldm_num_inference_steps", str(INFERENCE_STEPS)]
    main_auto(argv + ["--mode", "train", "--num_epochs", "1", "--eval_interval", "1",
                      "--batch_size", "8", "--max_eval_batches", "1"], device="cpu")
    return argv


def test_export_script_serves_a_latent_run(trained_ldm):
    """``scripts/export_model_torch.py`` on the run's best weights and its
    VAE: the served rollout gives ``main_multistep``'s frames (its noise
    keyed by seed 0, as a served call without noise draws it)."""
    from cfdbench_tpu_torch.cli import main_multistep
    from cfdbench_tpu_torch.data import load_test_cases
    from cfdbench_tpu_torch.utils.export import load_exported

    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import export_model_torch
    finally:
        sys.path.remove(str(REPO / "scripts"))
    features, case_params = load_test_cases(Args.parse_args(trained_ldm), 20)
    n = features.shape[0]
    serve = export_model_torch.main(trained_ldm + ["--batch_size", str(n), "--device", "cpu"])
    assert sorted(p.name for p in serve.iterdir()) == ["predict.pt2", "rollout.pt2"]
    want = main_multistep(trained_ldm, device="cpu")
    rollout = load_exported(serve / "rollout.pt2")
    assert rollout.sampler == dict(kind="rollout", steps=INFERENCE_STEPS,
                                   noise_shape=[20, INFERENCE_STEPS + 1, n, 2, 2, 4])
    with torch.inference_mode():
        got = rollout(t(features[:, 0, :, :, :2]), t(case_params), t(features[:, 0, :, :, 2:3]))
    assert got.shape == want.shape == (20, n, 16, 16, 2)
    assert (got - want).abs().max().item() <= SERVED_ATOL
