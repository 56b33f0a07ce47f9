"""Diffusion tasks (port of ``cfdbench_tpu/models/diffusion.py``).

Each task couples its trainable network (``task.model``: a
:class:`PUNetGCFD`, or a latent model's :class:`LatentDenoiser`) with the
DDPM scheduler and a loss, behind the interface the trainers drive
(``training/trainer_auto.py``): ``loss_scores(batch, key)`` (the
noise-prediction scores), ``predict_frame`` (a frame by full DDPM
sampling), ``feedback_channels``, ``step_draws`` and ``generative``.
``predict_frame(..., noise=)`` takes the sampler's noise, of
``noise_shape(frame_shape)``, in place of the draws from its key: the
serving export makes it an input of the program (``utils/export.py``).

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
``ops.diffusion.ddpm_noise`` (stacked by ``sampler_noise``), a latent
model's posterior sample from ``vae.posterior_noise``: module-level
functions, so a test can put JAX's draws in their place
(``utils/rng.py``). A latent model's loss splits its
key in two (``latent_keys``), as JAX's ``rng, vkey = split(rng)``. With
``use_gradient_checkpointing`` the network's forward is recomputed in the
backward (``torch.utils.checkpoint``; the JAX package's
``jax.checkpoint``), on masks drawn before it.

Mixed precision (``--use_mixed_precision``): a task whose
``compute_dtype`` is ``torch.bfloat16`` runs the train loss's network on
bfloat16 copies of its float32 parameters (``common.cast_call``) with
its input and case parameters in bfloat16, and scores the prediction in
float32; evaluation and generation stay float32. The latent models cast
their UNet only: the frozen VAE, the v1 ``context_proj`` and the Lite
``CondEncoder`` run in float32 and their outputs are cast, as in the JAX
package (``cfdbench_tpu/models/diffusion.py:451-455, 641-644``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..metrics import LossFn
from ..ops.diffusion import ddpm_sample, make_ddpm_scheduler
from ..parallel.mesh import SINGLE
from ..parallel.spatial import Rows, active, all_rows, reshard, row_span, take_rows, to_pairs
from ..utils.rng import (
    EVAL_KEY,
    Key,
    generator as key_generator,
    latent_keys,
    rollout_key,
    train_key,
)
from .common import Conv, Dense, GroupNorm, cast_call
from .punetg import PUNetGCFD, dropout_keep_masks
from .vae import AutoencoderKL


def train_noise_and_t(key: Key, shape, num_train_timesteps: int,
                      device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A loss's noise (``shape``) and per-sample timesteps in [0, T)."""
    gen = key_generator(key, device)
    noise = torch.randn(tuple(shape), generator=gen, device=device)
    t = torch.randint(0, num_train_timesteps, (shape[0],), generator=gen, device=device)
    return noise, t


def to_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """A prediction as the loss reads it: bfloat16 widened to float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class _DiffusionTask:
    pointwise = False
    # Evaluation generates frames and scores them (masked frame mse/nmse,
    # the reference's evaluate_ldm), not the noise prediction.
    generative = True
    # The data axis: every draw is made over the global batch and sliced
    # to this rank's block (trainer_auto.use_mesh).
    mesh = SINGLE
    # The model axis the grid rows split over (trainer_auto.use_spatial):
    # every draw is made over the global grid too and sliced to the rows.
    rows = None

    def __init__(self, model: nn.Module, loss_fn: Optional[LossFn], out_chan: int,
                 timesteps: int):
        self.model = model
        self.loss_fn = loss_fn
        self.out_chan = out_chan
        self.scheduler = make_ddpm_scheduler(timesteps, device=next(model.parameters()).device)
        self.num_inference_steps = 50
        self.use_gradient_checkpointing = False
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def feedback_channels(self) -> int:
        return self.out_chan

    def train_dtype(self, key: Optional[Key]) -> Optional[torch.dtype]:
        """The dtype the network computes in under ``loss_scores(batch,
        key)``: ``compute_dtype`` in a train step (a key), else None."""
        return None if key is None else self.compute_dtype

    def step_draws(self, seed: int, step: int, device) -> Key:
        """What ``loss_scores`` takes for train step ``step``: its key."""
        return train_key(seed, step)

    def global_shape(self, shape, rows: Optional[Rows] = None) -> Tuple[int, ...]:
        """The global shape of a field of which this rank holds ``shape``:
        its block of the batch and, under spatial sharding, its rows (of the
        even split, or of ``rows``)."""
        shape = list(self.mesh.global_shape(shape))
        shape[1] = row_span(shape[1], self.rows if rows is None else rows)[1]
        return tuple(shape)

    def _eps(self, x, t, case_params, key: Optional[Key]):
        unet = self.model
        if key is None:
            return unet(x, t, case_params)
        mesh = self.mesh
        # Over the global batch and grid: the network takes each mask's rows
        # at its level (punetg.py).
        masks = ([mesh.block(m) for m in dropout_keep_masks(
                     key, unet.dropout_shapes(self.global_shape(x.shape)), unet.dropout,
                     x.device)]
                 if unet.dropout > 0 else [])
        dtype = self.train_dtype(key)
        x, case_params = to_dtype(x, dtype), to_dtype(case_params, dtype)
        if not self.use_gradient_checkpointing:
            return cast_call(unet, dtype, x, t, case_params, masks or None)
        # Under a model axis the recompute runs the whole forward, so every
        # gather hook runs, before and after its module, as in the forward
        # and alike on every model rank (early stopping would leave the
        # last modules' gathered weights in place).
        with set_checkpoint_early_stop(not self.mesh.model.distributed):
            return checkpoint(lambda x_, cp_, *m: cast_call(unet, dtype, x_, t, cp_, m or None),
                              x, case_params, *masks, use_reentrant=False)

    def _noise_scores(self, x0, batch, key: Optional[Key], network_input=lambda noisy: noisy):
        """``(loss, scores)`` of the network's noise prediction on ``x0``
        noised at random timesteps."""
        noise, t = map(self.mesh.block, train_noise_and_t(
            EVAL_KEY if key is None else key, self.global_shape(x0.shape),
            self.scheduler.num_train_timesteps, x0.device))
        noise = take_rows(noise, self.rows)
        noisy = self.scheduler.add_noise(x0, noise, t)
        eps = at_least_f32(self._eps(network_input(noisy), t, batch["case_params"], key))
        scores = self.loss_fn(eps, noise, sample_weights=batch.get("weights"))
        return scores[self.loss_fn.objective], scores

    def sample_shape(self, frame_shape) -> Tuple[int, ...]:
        """The shape the sampler draws for a frame of ``frame_shape``."""
        B, H, W = frame_shape[:3]
        return B, H, W, self.out_chan

    def sample_rows(self, frame_shape):
        """The split of the sampler's draws for a frame of ``frame_shape``
        (a rank's rows under spatial sharding): the model axis, whose even
        split it is."""
        return self.rows

    def noise_shape(self, frame_shape) -> Tuple[int, ...]:
        """``(num_inference_steps + 1, *sample_shape)``: the sampler's noise
        for a frame of ``frame_shape`` (``ops.diffusion.ddpm_sample``)."""
        return (self.num_inference_steps + 1, *self.sample_shape(frame_shape))

    def _sample(self, denoise, like: torch.Tensor, key: Key, operands, noise=None) -> torch.Tensor:
        """``ddpm_sample`` of ``denoise(x, t, *operands)`` (which reads no
        tensor but ``self.model``'s and ``operands``) for a frame like
        ``like``."""
        return ddpm_sample(self.scheduler, denoise, self.sample_shape(like.shape), key,
                           self.num_inference_steps, like.device, self.mesh, noise, operands,
                           self.model, self.sample_rows(like.shape))


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

    def predict_frame(self, inputs, case_params, mask, key: Key = EVAL_KEY, noise=None):
        """The next frame by full DDPM sampling from noise (``noise``, else
        drawn from ``key``; it never reads ``inputs`` but for its shape),
        masked."""
        frame = self._sample(self.model, inputs, key, (case_params,), noise)
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
        def denoise(x, t, inputs, inputs_prev, case_params):
            return self.model(torch.cat([x, inputs, inputs_prev], dim=-1), t, case_params)

        residual = (self._sample(denoise, inputs, key, (inputs, inputs_prev, case_params))
                    * self.residual_std + self.residual_mean)
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

# The frozen VAE's downsampling factor, 2 ** its downsamples: fields are
# zero-padded to a multiple of it, so that its floor chain and the
# CondEncoder's ceil chain agree (tube's and dam's 66x65 fields), and the
# decode is cropped back.
VAE_DOWNSAMPLES = 3
VAE_FACTOR = 2 ** VAE_DOWNSAMPLES
# LatentDiffusionCfdModel's context width (the JAX class's default, which
# its entry point keeps).
CONTEXT_DIM = 64


def padded_rows(rows: Optional[Rows]) -> Optional[Rows]:
    """The split of a grid split as ``rows`` once :func:`pad_field` has
    padded it: the last rank gains the pad rows (66 rows at ``1x2``,
    ``(0, 33, 66)``, become ``(0, 33, 72)``). None without a split."""
    if rows is None:
        return None
    return rows.resized(rows.H + (-rows.H) % VAE_FACTOR)


def pad_field(x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
    """``x`` (B, H, W, C) zero-padded at the bottom and right to multiples
    of ``VAE_FACTOR``. Under ``rows`` (spatial sharding) x is a rank's rows:
    the columns are padded on every rank, the bottom rows on the last rank
    alone (:func:`padded_rows` is the split of the result)."""
    ph = (-x.shape[1]) % VAE_FACTOR if rows is None else padded_rows(rows).h - rows.h
    pw = (-x.shape[2]) % VAE_FACTOR
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

    def forward(self, inputs, case_params, rows: Optional[Rows] = None):
        """Under ``rows`` (spatial sharding) ``inputs`` is a rank's rows of
        the padded grid, and each stride-2 conv reads its level resharded to
        whole row pairs; the output's split is :meth:`out_rows`."""
        h = inputs
        for conv, norm in zip(self.convs, self.norms):
            h, rows = to_pairs(h, rows)
            h = norm(F.silu(conv(h, rows)))
            rows = None if rows is None else rows.halved(ceil=True)
        p = F.silu(self.param_fc2(F.silu(self.param_fc1(case_params))))
        B, hh, ww, _ = h.shape
        h = torch.cat([h, p[:, None, None, :].expand(B, hh, ww, p.shape[-1])], dim=-1)
        return self.conv_out(self.norm_mix(F.silu(self.conv_mix(h, rows))), rows)

    def out_rows(self, rows: Rows) -> Rows:
        """The output's split for an input split ``rows``."""
        return rows.halvings(len(self.convs), ceil=True)[-1]


class LatentDenoiser(nn.Module):
    """A latent model's trainable networks: ``unet`` and, by version,
    ``context_proj`` (v1) or ``cond_encoder`` (Lite); the JAX checkpoint's
    ``params`` tree holds the same nests."""

    # The parts the task calls, each for its whole forward: under spatial
    # sharding the gather-at-use hooks sit on them (parallel/tensor.py).
    PARTS = ("unet", "context_proj", "cond_encoder")

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
        """What the input frame and the case parameters give the UNet; under
        spatial sharding ``inputs`` is a rank's rows."""
        raise NotImplementedError

    def denoise(self, noisy, t, case_params, cond, dtype: Optional[torch.dtype] = None,
                rows: Optional[Rows] = None):
        """The UNet's noise prediction on the latents ``noisy`` at
        timesteps ``t``, given ``cond = condition(inputs, case_params)``;
        with ``dtype``, the UNet's parameters and inputs cast to it; under
        spatial sharding ``noisy`` is a rank's rows of the split ``rows``."""
        raise NotImplementedError

    def field_rows(self, h: int) -> Optional[Rows]:
        """The even split of a grid of which this rank holds ``h`` rows
        under spatial sharding (the batch's), else None."""
        return Rows.of(h, self.rows) if active(self.rows) else None

    def latent_rows(self, h: int) -> Optional[Rows]:
        """The latents' split for a field of which this rank holds ``h``
        rows of the even split: the padded grid's (:func:`padded_rows`)
        through the VAE's downsamples. None without spatial sharding."""
        return self.vae.latent_rows(padded_rows(self.field_rows(h)))

    def loss_scores(self, batch, key: Optional[Key] = None):
        """``(loss, scores)`` of the UNet's noise prediction on the frozen
        VAE's latents of the padded label (a posterior sample, no gradient),
        noised at random timesteps; every draw over the global batch and
        latent grid, sliced."""
        noise_key, posterior_key = latent_keys(EVAL_KEY if key is None else key)
        label = batch["labels"][..., :self.out_chan]
        rows = self.field_rows(label.shape[1])
        lrows = self.latent_rows(label.shape[1])
        with torch.no_grad():
            latents = (self.vae.encode(pad_field(label, rows), padded_rows(rows))
                       .sample(posterior_key, self.mesh, lrows) * self.scaling_factor)
        noise, t = map(self.mesh.block, train_noise_and_t(
            noise_key, self.global_shape(latents.shape, lrows),
            self.scheduler.num_train_timesteps, latents.device))
        noise = take_rows(noise, lrows)
        noisy = self.scheduler.add_noise(latents, noise, t)
        cp = batch["case_params"]
        eps = at_least_f32(self.denoise(noisy, t, cp, self.condition(batch["inputs"], cp),
                                        self.train_dtype(key), lrows))
        scores = self.loss_fn(eps, noise, sample_weights=batch.get("weights"))
        return scores[self.loss_fn.objective], scores

    def sample_shape(self, frame_shape) -> Tuple[int, ...]:
        """The latents of the frame's grid padded to multiples of
        ``VAE_FACTOR`` (under spatial sharding, the rank's rows of them)."""
        B, H, W = frame_shape[:3]
        shape = self.vae.latent_shape((B, H + (-H) % VAE_FACTOR, W + (-W) % VAE_FACTOR))
        lrows = self.latent_rows(H)
        return shape if lrows is None else (B, lrows.h, *shape[2:])

    def sample_rows(self, frame_shape):
        return self.latent_rows(frame_shape[1])

    def predict_frame(self, inputs, case_params, mask, key: Key = EVAL_KEY, noise=None):
        """The next frame: latents by full DDPM sampling (from ``noise``,
        else drawn from ``key``), decoded ÷ ``scaling_factor``, cropped to
        the grid, masked. Under spatial sharding the decode's split, its
        pad rows dropped on the last rank, is resharded to the batch's."""
        h, W = inputs.shape[1:3]
        rows, lrows = self.field_rows(h), self.latent_rows(h)
        with torch.no_grad():
            cond = self.condition(inputs, case_params)
            latents = self._sample(partial(self.denoise, rows=lrows), inputs, key,
                                   (case_params, cond), noise)
            frame = self.vae.decode(latents / self.scaling_factor, lrows)[:, :, :W]
            if rows is None:
                frame = frame[:, :h]
            else:
                cropped = self.vae.decoded_rows(lrows).resized(rows.H)
                frame = reshard(frame[:, :cropped.h], cropped, rows)
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
        """The context: the tokens of the rank's rows (projected, v1), and
        under spatial sharding every rank's, gathered differentiably (the
        cross-attention's keys and values read the whole grid's)."""
        tokens = self._context_tokens(inputs, case_params)
        ctx = tokens if self._raw_context else self.model.context_proj(tokens)
        rows = self.field_rows(inputs.shape[1])
        if rows is None:
            return ctx
        B, h, W = inputs.shape[:3]
        return all_rows(ctx.reshape(B, h, W, -1), rows).reshape(B, rows.H * W, -1)

    def denoise(self, noisy, t, case_params, cond, dtype=None, rows=None):
        return cast_call(self.model.unet, dtype, to_dtype(noisy, dtype), t,
                         to_dtype(case_params, dtype), context=to_dtype(cond, dtype), rows=rows)


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
        """The CondEncoder of the padded input, under spatial sharding on
        the rank's rows; its output split must be the latents'
        (``denoise`` adds the two)."""
        field = self.field_rows(inputs.shape[1])
        rows, enc = padded_rows(field), self.model.cond_encoder
        if rows is not None and enc.out_rows(rows) != self.vae.latent_rows(rows):
            raise ValueError(f"--shard_spatial 1: the CondEncoder's rows {enc.out_rows(rows)} "
                             f"are not the latents' {self.vae.latent_rows(rows)}")
        return enc(pad_field(inputs[..., :self.in_chan], field), case_params, rows)

    def denoise(self, noisy, t, case_params, cond, dtype=None, rows=None):
        return cast_call(self.model.unet, dtype, to_dtype(noisy + cond, dtype), t,
                         to_dtype(case_params, dtype), rows=rows)
