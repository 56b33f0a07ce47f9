"""DDPM noise scheduler and sampler (port of ``cfdbench_tpu/ops/diffusion.py``).

The behaviour of ``diffusers.DDPMScheduler(num_train_timesteps,
beta_schedule="squaredcos_cap_v2")`` with its default config (epsilon
prediction, fixed-small variance, x0 clipped to [-1, 1]), as the JAX
package implements it:

- betas: the improved-DDPM cosine schedule, computed in float64 numpy and
  cast to float32; ``alphas`` and their cumulative product in float32;
- ``add_noise``: sqrt(acp_t) x0 + sqrt(1 - acp_t) eps;
- ``spaced_timesteps(n)``: leading spacing, descending;
- ``step``: one ancestral step with x0 clipping and the fixed-small
  posterior variance; noise is added for t > 0.

The per-step coefficients are float32 scalars computed on the host from
the float32 tables, with the JAX package's operations in its order, so
the sampler launches only the elementwise work on the device.
:func:`ddpm_sample` is a Python loop of denoise calls (the JAX package's
``lax.scan``). Its noise comes from :func:`ddpm_noise`, one draw per
index of the sampling run, so a test can put JAX's draws in its place.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..utils.rng import Key, generator

# diffusers' default ``clip_sample_range``: the predicted x0 is clipped to it.
CLIP_SAMPLE_RANGE = 1.0
# The word a sampling run's draws append to its key ("ddpm"; ``utils/rng.py``).
SAMPLER_TAG = 0x6464706D


class DDPMScheduler:
    """The schedule's float32 tables on ``device`` (``betas``, ``alphas``,
    ``alphas_cumprod``), with host copies for the sampler's coefficients."""

    def __init__(self, betas: np.ndarray, num_train_timesteps: int, device=None):
        betas = torch.from_numpy(np.asarray(betas, np.float32).copy())
        alphas = 1.0 - betas
        alphas_cumprod = torch.cumprod(alphas, 0)  # on the host: a sequential product
        self._acp = alphas_cumprod.numpy()
        self.betas, self.alphas, self.alphas_cumprod = (
            t.to(device) for t in (betas, alphas, alphas_cumprod))
        self.num_train_timesteps = num_train_timesteps

    def add_noise(self, original_samples, noise, timesteps):
        """``timesteps``: (B,) integers, on the samples' device."""
        acp = self.alphas_cumprod[timesteps]
        shape = (-1,) + (1,) * (original_samples.dim() - 1)
        return acp.sqrt().reshape(shape) * original_samples + (1.0 - acp).sqrt().reshape(
            shape) * noise

    def spaced_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Leading spacing, descending (diffusers' ``set_timesteps``)."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
        return ts.astype(np.int32).copy()

    def step_coefficients(self, timestep: int, prev_timestep: int) -> Tuple[np.float32, ...]:
        """Float32 ``(sqrt(1 - acp_t), sqrt(acp_t), x0 coefficient, sample
        coefficient, posterior std)`` of the step t → prev_t; a negative
        ``prev_timestep`` is the final step (acp_prev = 1)."""
        one = np.float32(1.0)
        acp_t = self._acp[timestep]
        acp_prev = self._acp[prev_timestep] if prev_timestep >= 0 else one
        beta_prod_t = one - acp_t
        current_alpha_t = acp_t / acp_prev
        current_beta_t = one - current_alpha_t
        x0_coeff = np.sqrt(acp_prev) * current_beta_t / beta_prod_t
        sample_coeff = np.sqrt(current_alpha_t) * (one - acp_prev) / beta_prod_t
        variance = max((one - acp_prev) / (one - acp_t) * current_beta_t, np.float32(1e-20))
        return np.sqrt(beta_prod_t), np.sqrt(acp_t), x0_coeff, sample_coeff, np.sqrt(variance)

    def step(self, model_output, timestep: int, sample, prev_timestep: int, noise=None):
        """One ancestral denoising step t → prev_t (epsilon prediction);
        ``noise`` (the sample's shape) is added, scaled by the posterior
        std, when given and t > 0."""
        sqrt_beta_prod, sqrt_acp, x0_coeff, sample_coeff, std = self.step_coefficients(
            timestep, prev_timestep)
        pred_x0 = (sample - float(sqrt_beta_prod) * model_output) / float(sqrt_acp)
        pred_x0 = pred_x0.clamp(-CLIP_SAMPLE_RANGE, CLIP_SAMPLE_RANGE)
        prev_sample = float(x0_coeff) * pred_x0 + float(sample_coeff) * sample
        if noise is not None and timestep > 0:
            prev_sample = prev_sample + float(std) * noise
        return prev_sample


def make_ddpm_scheduler(num_train_timesteps: int = 1000, device=None) -> DDPMScheduler:
    """The ``squaredcos_cap_v2`` schedule of ``num_train_timesteps`` steps."""
    T = num_train_timesteps

    def alpha_bar(t):
        return np.cos((t / T + 0.008) / 1.008 * np.pi / 2) ** 2

    ts = np.arange(T)
    betas = np.minimum(1.0 - alpha_bar(ts + 1) / alpha_bar(ts), 0.999)
    return DDPMScheduler(betas, T, device=device)


def ddpm_noise(key: Key, index: int, shape, device) -> torch.Tensor:
    """Draw ``index`` of the sampling run keyed ``key``: 0 is x_T, i + 1 the
    noise of denoise step i."""
    gen = generator((*key, SAMPLER_TAG, index), device)
    return torch.randn(tuple(shape), generator=gen, device=device)


def ddpm_sample(scheduler: DDPMScheduler, denoise_fn: Callable, shape, key: Key,
                num_inference_steps: int = 50, device=None) -> torch.Tensor:
    """The full DDPM sampling loop from x_T: ``num_inference_steps`` calls
    of ``denoise_fn(x_t, t_batch) -> eps``. Every step draws its noise,
    the last (t = 0) too, as the JAX package does, and adds it for t > 0."""
    ts = scheduler.spaced_timesteps(num_inference_steps)
    step_ratio = scheduler.num_train_timesteps // num_inference_steps
    with torch.inference_mode():
        x = ddpm_noise(key, 0, shape, device)
        for i, t in enumerate(ts.tolist()):
            eps = denoise_fn(x, torch.full((shape[0],), t, dtype=torch.int64, device=device))
            x = scheduler.step(eps, t, x, t - step_ratio, ddpm_noise(key, i + 1, shape, device))
    return x
