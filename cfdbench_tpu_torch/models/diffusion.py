"""Diffusion tasks (port of ``cfdbench_tpu/models/diffusion.py``).

Each task couples its trainable network (``task.model``: a
:class:`PUNetGCFD`, or a latent model's :class:`LatentDenoiser`) with the
DDPM scheduler and a loss, behind the interface the trainers drive
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
- The latent diffusion models (``src/models/latent_diffusion.py``,
  ``ldm2.py``): a frozen lite VAE (``task.vae``, no part of ``task.model``,
  its optimizer or its ``model.pt``) encodes the label, zero-padded to a
  multiple of 8, to latents (a posterior sample × ``scaling_factor``); a
  latent PUNetG predicts their noise; generation samples latents, decodes
  them ÷ ``scaling_factor`` and crops to the grid. The three differ in
  how the input frame conditions the UNet:
  :class:`LatentDiffusionCfdModel` (v1) cross-attends over per-pixel
  tokens ``[u, v ‖ case_params]`` through a learned ``context_proj``
  (64 wide); :class:`LatentDiffusionCfdModel2` over the raw tokens;
  :class:`LatentDiffusionCfdModelLite` adds a :class:`CondEncoder`'s
  output to the noisy latents.

Randomness: a train step's key is ``train_key(seed, step)``; a key of
None is evaluation, drawn from ``EVAL_KEY`` without dropout, as the JAX package
uses ``PRNGKey(0)`` when ``rng`` is None. The noise and timesteps come
from :func:`train_noise_and_t`, the dropout masks from
``punetg.dropout_keep_masks``, the sampler's noise from
``ops.diffusion.ddpm_noise``, a latent model's posterior sample from
``vae.posterior_noise``: module-level functions, so a test can put JAX's
draws in their place (``utils/rng.py``). A latent model's loss splits its
key in two (``latent_keys``), as JAX's ``rng, vkey = split(rng)``. With
``use_gradient_checkpointing`` the network's forward is recomputed in the
backward (``torch.utils.checkpoint``; the JAX package's
``jax.checkpoint``), on masks drawn before it.

Not ported: bf16 compute (``--use_mixed_precision``, ROADMAP.md A6b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..metrics import LossFn
from ..ops.diffusion import ddpm_sample, make_ddpm_scheduler
from ..utils.rng import (
    EVAL_KEY,
    Key,
    generator as key_generator,
    latent_keys,
    rollout_key,
    train_key,
)
from .common import Conv, Dense, GroupNorm
from .punetg import PUNetGCFD, dropout_keep_masks
from .vae import AutoencoderKL


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

    def __init__(self, model: nn.Module, loss_fn: Optional[LossFn], out_chan: int,
                 timesteps: int):
        self.model = model
        self.loss_fn = loss_fn
        self.out_chan = out_chan
        self.scheduler = make_ddpm_scheduler(timesteps, device=next(model.parameters()).device)
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


# --- latent diffusion ------------------------------------------------------

# The frozen VAE's downsampling factor: fields are zero-padded to a
# multiple of it, so that its floor chain and the CondEncoder's ceil chain
# agree (tube's and dam's 66x65 fields), and the decode is cropped back.
VAE_FACTOR = 8
# LatentDiffusionCfdModel's context width (the JAX class's default, which
# its entry point keeps).
CONTEXT_DIM = 64


def pad_field(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, H, W, C) zero-padded at the bottom and right to multiples
    of ``VAE_FACTOR``."""
    ph, pw = (-x.shape[1]) % VAE_FACTOR, (-x.shape[2]) % VAE_FACTOR
    return F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x


class CondEncoder(nn.Module):
    """The Lite model's conditioning (``ldm2.py:263-289``): three stride-2
    convs (64, 128, 128), each followed by SiLU and GroupNorm(8); a 256-wide
    MLP over the case parameters, broadcast over the grid and concatenated;
    a conv to 128 (SiLU, GroupNorm(8)), then a conv to ``latent_dim``."""

    def __init__(self, in_chan: int, n_case_params: int, latent_dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        chans = (in_chan, 64, 128, 128)
        self.convs = nn.ModuleList(Conv(a, b, 3, padding=1, stride=2, **g)
                                   for a, b in zip(chans[:-1], chans[1:]))
        self.norms = nn.ModuleList(GroupNorm(8, c) for c in chans[1:])
        self.param_fc1, self.param_fc2 = Dense(n_case_params, 256, **g), Dense(256, 256, **g)
        self.conv_mix = Conv(128 + 256, 128, 3, padding=1, **g)
        self.norm_mix = GroupNorm(8, 128)
        self.conv_out = Conv(128, latent_dim, 3, padding=1, **g)

    def forward(self, inputs, case_params):
        h = inputs
        for conv, norm in zip(self.convs, self.norms):
            h = norm(F.silu(conv(h)))
        p = F.silu(self.param_fc2(F.silu(self.param_fc1(case_params))))
        B, hh, ww, _ = h.shape
        h = torch.cat([h, p[:, None, None, :].expand(B, hh, ww, p.shape[-1])], dim=-1)
        return self.conv_out(self.norm_mix(F.silu(self.conv_mix(h))))


class LatentDenoiser(nn.Module):
    """A latent model's trainable networks: ``unet`` and, by version,
    ``context_proj`` (v1) or ``cond_encoder`` (Lite); the JAX checkpoint's
    ``params`` tree holds the same nests."""

    def __init__(self, unet: PUNetGCFD, context_proj: Optional[Dense] = None,
                 cond_encoder: Optional[CondEncoder] = None):
        super().__init__()
        self.unet = unet
        if context_proj is not None:
            self.context_proj = context_proj
        if cond_encoder is not None:
            self.cond_encoder = cond_encoder


class _LatentTask(_DiffusionTask):
    """A latent diffusion model on a frozen VAE; subclasses say how the
    input frame conditions the UNet (``condition``, ``denoise``)."""

    def __init__(self, model: LatentDenoiser, vae: AutoencoderKL, loss_fn: Optional[LossFn],
                 in_chan: int, out_chan: int, scaling_factor: float, timesteps: int):
        super().__init__(model, loss_fn, out_chan, timesteps)
        self.vae = vae.eval().requires_grad_(False)
        self.in_chan = in_chan
        self.scaling_factor = scaling_factor

    def condition(self, inputs, case_params):
        """What the input frame and the case parameters give the UNet."""
        raise NotImplementedError

    def denoise(self, noisy, t, case_params, cond):
        """The UNet's noise prediction on the latents ``noisy`` at
        timesteps ``t``, given ``cond = condition(inputs, case_params)``."""
        raise NotImplementedError

    def loss_scores(self, batch, key: Optional[Key] = None):
        """``(loss, scores)`` of the UNet's noise prediction on the frozen
        VAE's latents of the padded label (a posterior sample, no gradient),
        noised at random timesteps."""
        noise_key, posterior_key = latent_keys(EVAL_KEY if key is None else key)
        with torch.no_grad():
            label = pad_field(batch["labels"][..., :self.out_chan])
            latents = self.vae.encode(label).sample(posterior_key) * self.scaling_factor
        noise, t = train_noise_and_t(noise_key, latents.shape,
                                     self.scheduler.num_train_timesteps, latents.device)
        noisy = self.scheduler.add_noise(latents, noise, t)
        cp = batch["case_params"]
        eps = self.denoise(noisy, t, cp, self.condition(batch["inputs"], cp))
        scores = self.loss_fn(eps, noise, sample_weights=batch.get("weights"))
        return scores[self.loss_fn.objective], scores

    def predict_frame(self, inputs, case_params, mask, key: Key = EVAL_KEY):
        """The next frame: latents by full DDPM sampling, decoded
        ÷ ``scaling_factor``, cropped to the grid, masked."""
        H, W = inputs.shape[1:3]
        with torch.inference_mode():
            cond = self.condition(inputs, case_params)
            lat_shape = self.vae.latent_shape(pad_field(inputs[..., :self.out_chan]).shape)
            latents = ddpm_sample(self.scheduler,
                                  lambda x, t: self.denoise(x, t, case_params, cond),
                                  lat_shape, key, self.num_inference_steps, inputs.device)
            frame = self.vae.decode(latents / self.scaling_factor)[:, :H, :W]
        return frame if mask is None else frame * mask


def _latent_unet(latent_dim, n_case_params, base_channels, channel_mult, num_res_blocks,
                 context_dim, generator, device) -> PUNetGCFD:
    return PUNetGCFD(latent_dim, latent_dim, base_channels, n_case_params, channel_mult,
                     num_res_blocks, dropout=0.0, cross_attention=context_dim > 0,
                     context_dim=context_dim, generator=generator, device=device)


class LatentDiffusionCfdModel(_LatentTask):
    """LDM v1 (``src/models/latent_diffusion.py``): cross-attention over
    the per-pixel tokens through a learned ``context_proj``."""

    _raw_context = False

    def __init__(self, loss_fn: Optional[LossFn], vae: AutoencoderKL, in_chan: int = 2,
                 out_chan: int = 2, n_case_params: int = 5, latent_dim: int = 4,
                 scaling_factor: float = 4.5578, noise_scheduler_timesteps: int = 1000,
                 unet_base_channels: int = 64, unet_channel_mult=(1, 2, 4),
                 unet_num_res_blocks: int = 1, *, generator: torch.Generator, device=None):
        raw = self._raw_context
        ctx_dim = in_chan + n_case_params if raw else CONTEXT_DIM
        unet = _latent_unet(latent_dim, n_case_params, unet_base_channels, unet_channel_mult,
                            unet_num_res_blocks, ctx_dim, generator, device)
        proj = None if raw else Dense(in_chan + n_case_params, CONTEXT_DIM,
                                      generator=generator).to(device)
        super().__init__(LatentDenoiser(unet, context_proj=proj), vae, loss_fn, in_chan,
                         out_chan, scaling_factor, noise_scheduler_timesteps)

    def _context_tokens(self, inputs, case_params):
        """Per-pixel tokens ``[u, v ‖ case_params]``: (B, H·W, in_chan + P)."""
        B, H, W, _ = inputs.shape
        cp = case_params[:, None, None, :].expand(B, H, W, case_params.shape[-1])
        return torch.cat([inputs[..., :self.in_chan], cp], dim=-1).reshape(B, H * W, -1)

    def condition(self, inputs, case_params):
        tokens = self._context_tokens(inputs, case_params)
        return tokens if self._raw_context else self.model.context_proj(tokens)

    def denoise(self, noisy, t, case_params, cond):
        return self.model.unet(noisy, t, case_params, context=cond)


class LatentDiffusionCfdModel2(LatentDiffusionCfdModel):
    """Non-lite LDM2 (``src/models/ldm2.py:58-135``): cross-attention in
    the mid block over the raw per-pixel tokens, ``context_dim = in_chan +
    n_case_params`` (``ldm2.py:125-131``), no projection."""

    _raw_context = True


class LatentDiffusionCfdModelLite(_LatentTask):
    """Conditioning by addition (``src/models/ldm2.py:240-430``): the
    :class:`CondEncoder` of the padded input frame and the case parameters
    is added to the noisy latents."""

    def __init__(self, loss_fn: Optional[LossFn], vae: AutoencoderKL, in_chan: int = 2,
                 out_chan: int = 2, n_case_params: int = 5, latent_dim: int = 4,
                 scaling_factor: float = 4.5578, noise_scheduler_timesteps: int = 1000,
                 unet_base_channels: int = 64, unet_channel_mult=(1, 2, 4),
                 unet_num_res_blocks: int = 1, *, generator: torch.Generator, device=None):
        cond = CondEncoder(in_chan, n_case_params, latent_dim, generator=generator).to(device)
        unet = _latent_unet(latent_dim, n_case_params, unet_base_channels, unet_channel_mult,
                            unet_num_res_blocks, 0, generator, device)
        super().__init__(LatentDenoiser(unet, cond_encoder=cond), vae, loss_fn, in_chan,
                         out_chan, scaling_factor, noise_scheduler_timesteps)

    def condition(self, inputs, case_params):
        return self.model.cond_encoder(pad_field(inputs[..., :self.in_chan]), case_params)

    def denoise(self, noisy, t, case_params, cond):
        return self.model.unet(noisy + cond, t, case_params)
