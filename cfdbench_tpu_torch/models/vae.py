"""The convolutional KL-VAE (port of ``cfdbench_tpu/models/vae.py``, the
reference's ``src/models/cfd_vae.py``, an HF ``diffusers.AutoencoderKL``).

NHWC, as ``models/punetg.py``; parameter names are diffusers'
(``encoder.down_blocks.{i}.resnets.{j}.norm1``, ``…downsamplers.0.conv``,
``encoder.mid_block.attentions.0.to_q``, ``quant_conv``, …), so a state
dict reads like the reference's.

- :class:`DiagonalGaussian`: ``logvar`` clipped to [-30, 20]; ``kl()``
  to N(0, I) summed over the non-batch dims; ``mode()`` the mean;
  ``sample(key)`` draws its noise from :func:`posterior_noise`, a
  module-level function, so a test can put JAX's draw in its place.
- :class:`VaeResBlock`: GroupNorm (``num_groups_for(32, C)`` groups, eps
  1e-6) → SiLU → conv → GroupNorm → SiLU → conv, plus the input (a 1x1
  conv where the widths differ). Its dropout is always 0 in the JAX
  package, so the port has none.
- :class:`AttnBlock`: one head over the H·W tokens, q, k, v and the output
  as biased linear layers, scale 1/√C (XLA ops in the JAX package: no
  kernel).
- :class:`Encoder`: each downsample pads right and bottom by one, then a
  stride-2 3x3 conv with padding 0 (diffusers' ``Downsample2D``), so H →
  floor(H/2). :class:`Decoder`: ``layers_per_block + 1`` blocks a level,
  then a nearest 2x repeat and a conv.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.rng import Key, generator as key_generator
from .common import Conv, Dense, GroupNorm, num_groups_for

LOGVAR_RANGE = (-30.0, 20.0)


def posterior_noise(key: Key, shape, device) -> torch.Tensor:
    """The standard normal draw of a posterior sample keyed ``key``."""
    return torch.randn(tuple(shape), generator=key_generator(key, device), device=device)


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @property
    def std(self):
        return torch.exp(0.5 * self.logvar)

    def sample(self, key: Key) -> torch.Tensor:
        return self.mean + self.std * posterior_noise(key, self.mean.shape, self.mean.device)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to N(0, I), summed over the non-batch dims (diffusers'
        ``DiagonalGaussianDistribution.kl``)."""
        return 0.5 * (self.mean.square() + self.logvar.exp() - 1.0 - self.logvar).sum(
            dim=tuple(range(1, self.mean.dim())))


def _gn(channels: int) -> GroupNorm:
    return GroupNorm(num_groups_for(32, channels), channels)


class VaeResBlock(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, *, generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        self.norm1 = _gn(in_chan)
        self.conv1 = Conv(in_chan, out_chan, 3, padding=1, **g)
        self.norm2 = _gn(out_chan)
        self.conv2 = Conv(out_chan, out_chan, 3, padding=1, **g)
        self.conv_shortcut = Conv(in_chan, out_chan, 1, **g) if in_chan != out_chan else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (diffusers' ``Attention`` in the
    VAE's mid block)."""

    def __init__(self, channels: int, *, generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        self.group_norm = _gn(channels)
        self.to_q, self.to_k, self.to_v = (Dense(channels, channels, **g) for _ in range(3))
        self.to_out = nn.ModuleList([Dense(channels, channels, **g)])

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax(q @ k.transpose(1, 2) / C ** 0.5, dim=-1)
        return x + self.to_out[0](attn @ v).reshape(B, H, W, C)


class MidBlock(nn.Module):
    """VaeResBlock → AttnBlock → VaeResBlock at the deepest width."""

    def __init__(self, channels: int, *, generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        self.resnets = nn.ModuleList([VaeResBlock(channels, channels, **g) for _ in range(2)])
        self.attentions = nn.ModuleList([AttnBlock(channels, **g)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class _Sampler(nn.Module):
    """diffusers' ``Downsample2D``/``Upsample2D`` holder: one ``conv``."""

    def __init__(self, channels: int, stride: int, padding: int, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=padding, stride=stride,
                         generator=generator)


class _Level(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, n_blocks: int, sampler, *,
                 generator: torch.Generator):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VaeResBlock(in_chan if j == 0 else out_chan, out_chan, generator=generator)
             for j in range(n_blocks)])
        if sampler is not None:
            name = "downsamplers" if sampler == "down" else "upsamplers"
            stride, padding = (2, 0) if sampler == "down" else (1, 1)
            setattr(self, name, nn.ModuleList(
                [_Sampler(out_chan, stride, padding, generator=generator)]))


class Encoder(nn.Module):
    def __init__(self, in_chan: int, block_out_channels: Sequence[int], latent_channels: int,
                 layers_per_block: int = 1, *, generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        chans = list(block_out_channels)
        self.conv_in = Conv(in_chan, chans[0], 3, padding=1, **g)
        blocks, prev = [], chans[0]
        for i, ch in enumerate(chans):
            last = i == len(chans) - 1
            blocks.append(_Level(prev, ch, layers_per_block, None if last else "down", **g))
            prev = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(prev, **g)
        self.conv_norm_out = _gn(prev)
        self.conv_out = Conv(prev, 2 * latent_channels, 3, padding=1, **g)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down_blocks:
            for block in level.resnets:
                h = block(h)
            if hasattr(level, "downsamplers"):
                # Pad right and bottom by one, then stride 2 with padding 0.
                h = level.downsamplers[0].conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], latent_channels: int, out_chan: int,
                 layers_per_block: int = 1, *, generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        chans = list(reversed(block_out_channels))
        self.conv_in = Conv(latent_channels, chans[0], 3, padding=1, **g)
        self.mid_block = MidBlock(chans[0], **g)
        blocks, prev = [], chans[0]
        for i, ch in enumerate(chans):
            last = i == len(chans) - 1
            blocks.append(_Level(prev, ch, layers_per_block + 1, None if last else "up", **g))
            prev = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _gn(prev)
        self.conv_out = Conv(prev, out_chan, 3, padding=1, **g)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for level in self.up_blocks:
            for block in level.resnets:
                h = block(h)
            if hasattr(level, "upsamplers"):
                B, H, W, C = h.shape
                h = h[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)
                h = level.upsamplers[0].conv(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """KL-VAE: ``encode`` → :class:`DiagonalGaussian` over the latents,
    ``decode`` → the reconstruction. Parameters are drawn from
    ``generator`` on the CPU, then moved to ``device``."""

    def __init__(self, in_chan: int = 2, out_chan: int = 2, latent_channels: int = 4,
                 block_out_channels: Sequence[int] = (32, 64, 128, 256),
                 layers_per_block: int = 1, *, generator: torch.Generator, device=None):
        super().__init__()
        g = dict(generator=generator)
        self.block_out_channels = tuple(block_out_channels)
        self.latent_channels = latent_channels
        self.encoder = Encoder(in_chan, block_out_channels, latent_channels, layers_per_block,
                               **g)
        self.decoder = Decoder(block_out_channels, latent_channels, out_chan, layers_per_block,
                               **g)
        self.quant_conv = Conv(2 * latent_channels, 2 * latent_channels, 1, **g)
        self.post_quant_conv = Conv(latent_channels, latent_channels, 1, **g)
        self.to(device)

    def encode(self, x) -> DiagonalGaussian:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return DiagonalGaussian(mean, logvar.clamp(*LOGVAR_RANGE))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, key: Key = None):
        """``(reconstruction, posterior)``: the posterior sampled with
        ``key`` when one is given, else its mode (diffusers'
        ``sample_posterior``)."""
        posterior = self.encode(x)
        z = posterior.mode() if key is None else posterior.sample(key)
        return self.decode(z), posterior

    def latent_shape(self, x_shape) -> Tuple[int, int, int, int]:
        """The latents' shape for an input of ``x_shape``: each downsample
        maps H to floor(H/2)."""
        B, H, W = x_shape[:3]
        for _ in range(len(self.block_out_channels) - 1):
            H, W = H // 2, W // 2
        return B, H, W, self.latent_channels


VARIANTS = {
    "v1": (64, 128),
    "v2": (64, 128, 256),
    "v3": (64, 128, 256, 512),
    "lite": (32, 64, 128, 256),
}


def make_cfd_vae(variant: str = "lite", in_chan: int = 2, out_chan: int = 2,
                 latent_dim: int = 4, ch: int = 64, ch_mult: Sequence[int] = (1, 2, 3, 4),
                 num_res_blocks: int = 2, *, generator: torch.Generator,
                 device=None) -> AutoencoderKL:
    """The CfdVae family (``src/models/cfd_vae.py:10-144``): ``lite``,
    ``v1``-``v3`` with one block a level, or ``custom``, whose channels are
    ``ch × ch_mult`` with ``num_res_blocks`` a level (the diffsci ddconfig
    path)."""
    init = dict(generator=generator, device=device)
    if variant == "custom":
        return AutoencoderKL(in_chan, out_chan, latent_dim, tuple(ch * m for m in ch_mult),
                             num_res_blocks, **init)
    if variant not in VARIANTS:
        raise ValueError(f"--vae_variant {variant!r}: choose from {', '.join(VARIANTS)} or custom")
    return AutoencoderKL(in_chan, out_chan, latent_dim, VARIANTS[variant], **init)
