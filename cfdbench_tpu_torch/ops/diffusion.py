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
the float32 tables, with the JAX package's operations in its order
(:meth:`DDPMScheduler.step_tables` puts them in float32 tensors, one
entry a step), so the sampler launches only the elementwise work on the
device. :func:`ddpm_sample` runs :func:`sampler_step` once a step: a
Python loop in process, and under ``torch.export`` one scan operator
(:func:`scan_loop`; the JAX package's ``lax.scan``), so that an exported
sampler holds one loop whatever its number of steps. Its noise is one
``(steps + 1, *shape)`` tensor: the caller's, or :func:`sampler_noise`'s
draws, one :func:`ddpm_noise` per index of the sampling run, so a test
can put JAX's draws in its place.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import SINGLE, DataMesh
from ..parallel.spatial import row_span, take_rows
from ..utils.rng import Key, generator

# diffusers' default ``clip_sample_range``: the predicted x0 is clipped to it.
CLIP_SAMPLE_RANGE = 1.0
# The word a sampling run's draws append to its key ("ddpm"; ``utils/rng.py``).
SAMPLER_TAG = 0x6464706D


class DDPMScheduler(nn.Module):
    """The schedule's float32 tables on ``device`` (``betas``, ``alphas``,
    ``alphas_cumprod``), with host copies for the sampler's coefficients.
    A module so that the sampler's per-step tables (:meth:`step_tables`)
    are its buffers, which an exported sampler reads as its state."""

    def __init__(self, betas: np.ndarray, num_train_timesteps: int, device=None):
        super().__init__()
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

    def step_tables(self, num_inference_steps: int, device=None) -> Tuple[torch.Tensor, ...]:
        """The steps of a ``num_inference_steps`` sampling run as six
        tensors of one entry a step on ``device`` (the tables' when None):
        the timesteps (int64) and :meth:`step_coefficients` of t → prev_t
        in float32, the posterior std 0 at t = 0, where no noise is added.
        Kept as the buffers ``ts`` and ``coeffs`` until another run's are
        asked for."""
        device = self.betas.device if device is None else torch.device(device)
        ts = getattr(self, "ts", None)
        if ts is None or len(ts) != num_inference_steps or ts.device != device:
            ts = self.spaced_timesteps(num_inference_steps)
            step_ratio = self.num_train_timesteps // num_inference_steps
            coeffs = np.array([self.step_coefficients(t, t - step_ratio) for t in ts.tolist()],
                              np.float32).T.copy()
            coeffs[-1, ts == 0] = 0.0
            self.register_buffer("ts", torch.as_tensor(ts.astype(np.int64), device=device),
                                 persistent=False)
            self.register_buffer("coeffs", torch.as_tensor(coeffs, device=device),
                                 persistent=False)
        return (self.ts, *self.coeffs)

    def step(self, model_output, timestep: int, sample, prev_timestep: int, noise=None):
        """One ancestral denoising step t → prev_t (epsilon prediction);
        ``noise`` (the sample's shape) is added, scaled by the posterior
        std, when given and t > 0."""
        *coeffs, std = (float(c) for c in self.step_coefficients(timestep, prev_timestep))
        prev_sample = ancestral_step(model_output, sample, *coeffs)
        if noise is not None and timestep > 0:
            prev_sample = prev_sample + std * noise
        return prev_sample


def ancestral_step(model_output, sample, sqrt_beta_prod, sqrt_acp, x0_coeff, sample_coeff):
    """The step's mean: x0 predicted from the noise, clipped, and mixed
    with the sample (coefficients as floats or 0-d tensors)."""
    pred_x0 = (sample - sqrt_beta_prod * model_output) / sqrt_acp
    pred_x0 = pred_x0.clamp(-CLIP_SAMPLE_RANGE, CLIP_SAMPLE_RANGE)
    return x0_coeff * pred_x0 + sample_coeff * sample


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


def sampler_noise(key: Key, steps: int, shape, device, mesh: DataMesh = SINGLE,
                  rows=None) -> torch.Tensor:
    """``(steps + 1, *shape)``: draws 0..steps of the sampling run keyed
    ``key`` (:func:`ddpm_noise`), each made over ``mesh``'s global batch
    and, under spatial sharding over ``rows`` (a model axis), the global
    grid, and sliced to its block (``shape``)."""
    global_shape = list(mesh.global_shape(shape))
    global_shape[1] = row_span(shape[1], rows)[1]
    return torch.stack([take_rows(mesh.block(ddpm_noise(key, i, global_shape, device)), rows)
                        for i in range(steps + 1)])


def scan_loop(step: Callable, carry: torch.Tensor, xs, module: nn.Module, operands=()):
    """``carry, out = step(carry, *row, *operands)`` for each row of the
    tensors ``xs`` (along their first axis), as one
    ``torch.ops.higher_order.scan``. Returns the last carry and the
    stacked outputs. ``step`` reads ``module``'s parameters and buffers,
    which enter the operator as inputs (the traced step must hold no
    tensor of the outer graph), as do the tensors ``operands``."""
    from torch._higher_order_ops.scan import scan_op
    from torch.nn.utils.stateless import _reparametrize_module

    names, state = zip(*module.named_parameters(), *module.named_buffers())
    n_xs, n_state = len(xs), len(state)

    def body(carry, *args):
        row, state_ = args[:n_xs], args[n_xs:n_xs + n_state]
        with _reparametrize_module(module, dict(zip(names, state_))):
            return list(step(carry, *row, *args[n_xs + n_state:]))

    return scan_op(body, [carry], list(xs), (*state, *operands))


def sampler_step(denoise_fn: Callable, x, step, operands=()):
    """One denoising step of the sampler: ``step`` is a row of
    :meth:`DDPMScheduler.step_tables` and the step's noise, ``(t,
    sqrt(1 - acp_t), sqrt(acp_t), x0 coefficient, sample coefficient,
    posterior std, noise)``; ``denoise_fn(x, t_batch, *operands)``."""
    t, *coeffs, std, noise = step
    eps = denoise_fn(x, t.expand(x.shape[0]), *operands)
    return ancestral_step(eps, x, *coeffs) + std * noise


def ddpm_sample(scheduler: DDPMScheduler, denoise_fn: Callable, shape, key: Key,
                num_inference_steps: int = 50, device=None, mesh: DataMesh = SINGLE,
                noise=None, operands=(), module: nn.Module = None, rows=None) -> torch.Tensor:
    """The full DDPM sampling loop from x_T: ``num_inference_steps`` calls
    of ``denoise_fn(x_t, t_batch, *operands) -> eps``, without gradients.
    ``noise`` is ``(num_inference_steps + 1, *shape)``: x_T, then each
    step's noise, the last (t = 0) too, which is not added, as in the JAX
    package; when None, :func:`sampler_noise` draws it from ``key``.
    ``shape`` is ``mesh``'s block of the batch (and under spatial sharding
    over ``rows`` its rows of the grid). Under ``torch.export`` the
    steps run as one scan operator, and ``denoise_fn`` may read no tensor
    but those of ``module`` (its network) and ``operands``."""
    want = (num_inference_steps + 1, *shape)
    if noise is None:
        noise = sampler_noise(key, num_inference_steps, shape, device, mesh, rows)
    elif tuple(noise.shape) != want:
        raise ValueError(f"the sampler's noise is {tuple(noise.shape)}; it takes {want}")
    steps = (*scheduler.step_tables(num_inference_steps, noise.device), noise[1:])
    with torch.no_grad():
        if torch.compiler.is_exporting():
            n = len(steps)

            def step_fn(x, *args):
                # The carry keeps x's layout; the step's output is its
                # timestep (scan stacks a tensor a step).
                x = sampler_step(denoise_fn, x, args[:n], args[n:]).contiguous()
                return x, args[0].clone()

            x, _ = scan_loop(step_fn, noise[0], steps, module, operands)
            return x
        x = noise[0]
        for i in range(num_inference_steps):
            x = sampler_step(denoise_fn, x, tuple(a[i] for a in steps), operands)
    return x
