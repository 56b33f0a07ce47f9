"""Serving the latent diffusion models: each one's ``torch.export``
artifact (``utils/export.py``) against the JAX package's ``jax.export``
one, at 18x17 (a grid the latent models pad to 24x24): v1 and v2 here,
the Lite model and ``scripts/export_model_torch.py`` on a trained latent
run in ``tests/test_torch_serving_diffusion_lite.py``. As
``tests/test_torch_serving_diffusion_pixel.py`` holds pixel diffusion:
the same weights and VAE in both packages, JAX's ``PRNGKey(0)`` sampler
draws as the noise input (repeated each step of the rollout, as JAX's
exported rollout draws them), predict within 1e-5 of max |frame| and a
2-step rollout within 1e-4 of its largest value, and, served without
noise, within 1e-6 of the in-process calls. The artifact carries the
frozen VAE, which is no part of ``task.model``.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_ldm import both_tasks
from tests.test_torch_diffusion import task_batch
from tests.test_torch_serving_diffusion_pixel import B, INFERENCE_STEPS, check_served, serve_both

torch.set_num_threads(1)


def serve_latent(name, tmp_path_factory):
    """The latent model ``name`` (``tests/test_torch_ldm.py::CLASSES``) at
    UNet base 8 on a lite VAE in both packages, 3 inference steps, and
    both packages' artifacts at 18x17."""
    port, jax_task, params = both_tasks(name)
    port.num_inference_steps = jax_task.num_inference_steps = INFERENCE_STEPS
    host = task_batch(np.random.default_rng(0), B=B, H=18, W=17)
    served = serve_both(tmp_path_factory.mktemp(name), port, jax_task, params, host)
    return port, host, served


def check_vae_rides(port, served):
    """The VAE's weights ride in the artifact beside the trained networks;
    the noise input is the padded grid's 3x3 latents."""
    predict = served["predict"][0]
    state = predict.program.state_dict
    vae = {f"vae.{k}" for k in port.vae.state_dict()}
    assert vae <= set(state) and {f"model.{k}" for k in port.model.state_dict()} <= set(state)
    assert predict.sampler["noise_shape"] == [INFERENCE_STEPS + 1, B, 3, 3, 4]


@pytest.fixture(scope="module", params=["v1", "v2"])
def latent(request, tmp_path_factory):
    return serve_latent(request.param, tmp_path_factory)


def test_served_latent_diffusion_matches_jax_and_in_process(latent):
    check_served(*latent)


def test_artifact_carries_the_frozen_vae(latent):
    port, _, served = latent
    check_vae_rides(port, served)
