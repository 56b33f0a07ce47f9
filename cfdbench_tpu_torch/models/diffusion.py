"""Diffusion tasks that need no VAE (port of the pixel-space half of
``cfdbench_tpu/models/diffusion.py``).

Each task couples a :class:`PUNetGCFD` (``task.model``) with the DDPM
scheduler and a loss, behind the interface the trainers drive
(``training/trainer_auto.py``): ``loss_scores(batch, key)`` (the
noise-prediction scores), ``predict_frame`` (a frame by full DDPM
sampling), ``feedback_channels``, ``step_draws`` and ``generative``.

- :class:`PixelDiffusionCfdModel` (``src/models/pixel_diffusion.py``):
  DDPM on the target frame. The reference's quirk stays: the frame never
  depends on ``inputs`` (SURVEY.md §8 #12), only on the noise, the
  timestep and the case parameters.
- :class:`GenCastCfdModel` (``src/models/gen_cast_cfd.py``): DDPM on the
  normalised residual X_t − X_{t−1}; the network sees [noisy residual,
  X_{t−1}, X_{t−2}]; ``generate`` adds the denoised residual to X_{t−1},
  masked; ``rollout`` keeps the two-frame window.

Randomness: a train step's key is ``train_key(seed, step)``; a key of
None is evaluation, drawn from ``EVAL_KEY`` without dropout, as the JAX package
uses ``PRNGKey(0)`` when ``rng`` is None. The noise and timesteps come
from :func:`train_noise_and_t`, the dropout masks from
``punetg.dropout_keep_masks``, the sampler's noise from
``ops.diffusion.ddpm_noise``: module-level functions, so a test can put
JAX's draws in their place (``utils/rng.py``). With
``use_gradient_checkpointing`` the network's forward is recomputed in the
backward (``torch.utils.checkpoint``; the JAX package's
``jax.checkpoint``), on masks drawn before it.

Not ported yet: the latent diffusion models, their VAE, ``_pad_field``
and ``_latent_shape`` (ROADMAP.md A13b); bf16 compute
(``--use_mixed_precision``, ROADMAP.md A6b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..metrics import LossFn
from ..ops.diffusion import ddpm_sample, make_ddpm_scheduler
from ..utils.rng import EVAL_KEY, Key, generator as key_generator, rollout_key, train_key
from .punetg import PUNetGCFD, dropout_keep_masks


def train_noise_and_t(key: Key, shape, num_train_timesteps: int,
                      device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A loss's noise (``shape``) and per-sample timesteps in [0, T)."""
    gen = key_generator(key, device)
    noise = torch.randn(tuple(shape), generator=gen, device=device)
    t = torch.randint(0, num_train_timesteps, (shape[0],), generator=gen, device=device)
    return noise, t


class _DiffusionTask:
    pointwise = False
    # Evaluation generates frames and scores them (masked frame mse/nmse,
    # the reference's evaluate_ldm), not the noise prediction.
    generative = True

    def __init__(self, unet: PUNetGCFD, loss_fn: Optional[LossFn], out_chan: int,
                 timesteps: int):
        self.model = unet
        self.loss_fn = loss_fn
        self.out_chan = out_chan
        self.scheduler = make_ddpm_scheduler(timesteps, device=unet.conv_in.weight.device)
        self.num_inference_steps = 50
        self.use_gradient_checkpointing = False

    @property
    def feedback_channels(self) -> int:
        return self.out_chan

    def step_draws(self, seed: int, step: int, device) -> Key:
        """What ``loss_scores`` takes for train step ``step``: its key."""
        return train_key(seed, step)

    def _eps(self, x, t, case_params, key: Optional[Key]):
        unet = self.model
        if key is None:
            return unet(x, t, case_params)
        masks = (dropout_keep_masks(key, unet.dropout_shapes(x.shape), unet.dropout, x.device)
                 if unet.dropout > 0 else [])
        if not self.use_gradient_checkpointing:
            return unet(x, t, case_params, masks or None)
        return checkpoint(lambda x_, cp_, *m: unet(x_, t, cp_, m or None), x, case_params,
                          *masks, use_reentrant=False)

    def _noise_scores(self, x0, batch, key: Optional[Key], network_input=lambda noisy: noisy):
        """``(loss, scores)`` of the network's noise prediction on ``x0``
        noised at random timesteps."""
        noise, t = train_noise_and_t(EVAL_KEY if key is None else key, x0.shape,
                                     self.scheduler.num_train_timesteps, x0.device)
        noisy = self.scheduler.add_noise(x0, noise, t)
        eps = self._eps(network_input(noisy), t, batch["case_params"], key)
        scores = self.loss_fn(eps, noise, sample_weights=batch.get("weights"))
        return scores[self.loss_fn.objective], scores

    def _sample(self, denoise, like: torch.Tensor, key: Key) -> torch.Tensor:
        B, H, W = like.shape[:3]
        return ddpm_sample(self.scheduler, denoise, (B, H, W, self.out_chan), key,
                           self.num_inference_steps, like.device)


class PixelDiffusionCfdModel(_DiffusionTask):
    def __init__(self, loss_fn: Optional[LossFn], out_chan: int = 2,
                 n_case_params: int = 5, noise_scheduler_timesteps: int = 1000,
                 base_channels: int = 64, channel_mults=(1, 2, 4), num_res_blocks: int = 2,
                 dropout: float = 0.1, *, generator: torch.Generator, device=None):
        unet = PUNetGCFD(out_chan, out_chan, base_channels, n_case_params, channel_mults,
                         num_res_blocks, dropout, generator=generator, device=device)
        super().__init__(unet, loss_fn, out_chan, noise_scheduler_timesteps)

    def loss_scores(self, batch, key: Optional[Key] = None):
        return self._noise_scores(batch["labels"][..., :self.out_chan], batch, key)

    def predict_frame(self, inputs, case_params, mask, key: Key = EVAL_KEY):
        """The next frame by full DDPM sampling from noise (it never reads
        ``inputs`` but for its shape), masked."""
        frame = self._sample(lambda x, t: self.model(x, t, case_params), inputs, key)
        return frame if mask is None else frame * mask


class GenCastCfdModel(_DiffusionTask):
    """The batch adds ``inputs_prev`` (X_{t−2})."""

    def __init__(self, loss_fn: Optional[LossFn], residual_mean: np.ndarray,
                 residual_std: np.ndarray, in_chan: int = 2, out_chan: int = 2,
                 n_case_params: int = 5, noise_scheduler_timesteps: int = 1000,
                 base_channels: int = 64, channel_mults=(1, 2, 4), num_res_blocks: int = 2,
                 dropout: float = 0.1, *, generator: torch.Generator, device=None):
        unet = PUNetGCFD(out_chan + 2 * in_chan, out_chan, base_channels, n_case_params,
                         channel_mults, num_res_blocks, dropout, generator=generator,
                         device=device)
        super().__init__(unet, loss_fn, out_chan, noise_scheduler_timesteps)

        def stat(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device).reshape(1, 1, 1, -1)

        self.residual_mean, self.residual_std = stat(residual_mean), stat(residual_std)

    def normalize_residual(self, residual):
        return (residual - self.residual_mean) / (self.residual_std + 1e-6)

    def loss_scores(self, batch, key: Optional[Key] = None):
        inputs, prev = batch["inputs"], batch["inputs_prev"]
        norm_res = self.normalize_residual(batch["labels"][..., :self.out_chan] - inputs)
        return self._noise_scores(norm_res, batch, key,
                                  lambda noisy: torch.cat([noisy, inputs, prev], dim=-1))

    def generate(self, inputs, inputs_prev, case_params, mask, key: Key = EVAL_KEY):
        """X_t from X_{t−1} (``inputs``) and X_{t−2}: the denoised residual,
        de-normalised, added to X_{t−1}, masked."""
        def denoise(x, t):
            return self.model(torch.cat([x, inputs, inputs_prev], dim=-1), t, case_params)

        residual = self._sample(denoise, inputs, key) * self.residual_std + self.residual_mean
        nxt = inputs + residual
        return nxt if mask is None else nxt * mask

    def rollout(self, frame0, frame_prev0, case_params, mask, steps: int, seed: int = 0):
        """``(steps, B, H, W, C)``: each frame generated from the two before
        it (``gen_cast_cfd.py:275-308``), step s with key
        ``rollout_key(seed, s, steps)``."""
        with torch.inference_mode():
            frames = torch.empty((steps, *frame0.shape), device=frame0.device)
            cur, prev = frame0, frame_prev0
            for s in range(steps):
                frames[s] = self.generate(cur, prev, case_params, mask,
                                          key=rollout_key(seed, s, steps))
                cur, prev = frames[s], cur
        return frames
