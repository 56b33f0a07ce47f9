"""PUNetG: the conditional diffusion U-Net with FiLM conditioning (port of
``cfdbench_tpu/models/punetg.py``, the reference's ``src/models/punetg.py``).

- Conditioning: a sinusoidal timestep embedding through a 2-layer MLP and
  the case parameters through another, concatenated (8 x base wide).
- FilmResBlock: GroupNorm → SiLU → conv → GroupNorm → FiLM (x·(1 + scale)
  + shift) → SiLU → dropout → conv, plus the input (a 1x1 conv where the
  widths differ).
- Encoder: per level ``num_res_blocks`` blocks, then a stride-2 conv
  (padding 1, so W → ceil(W/2)); two middle blocks; decoder: per level a
  nearest x2 repeat cropped to the matching skip's shape and a conv, then
  ``num_res_blocks + 1`` blocks on the concatenation with a skip; a
  GroupNorm → SiLU → conv head. The skips are the JAX package's balanced
  bookkeeping (the conv-in output and every downsample output are pushed
  too), which the reference's own bookkeeping lacks (SURVEY.md §8).
- GroupNorms use eps 1e-6 (``common.GroupNorm``).

Dropout runs only where the caller passes keep masks, one per
FilmResBlock in call order (:func:`dropout_keep_masks`): the task draws
them from the step's key before the forward, so a recomputed forward
(gradient checkpointing) applies the same masks. The cross-attention
block of the latent models (``CrossAttnBlock``) is not ported yet
(ROADMAP.md A13b). Convolutions are cuDNN calls on the card; no TPU
kernel covers this model.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.rng import Key, generator as key_generator
from .common import Conv, Dense, GroupNorm, num_groups_for

# The JAX package folds this word ("drop") into the step's key to draw
# the dropout masks (models/diffusion.py, loss_scores).
DROPOUT_TAG = 0x64726F70


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding (``punetg.py:119-136``): freqs =
    exp(-log(1e4)·i/(dim/2 − 1)), concat(sin, cos), zero-padded to an odd
    ``dim``."""
    half = dim // 2
    exponent = -math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device) * exponent)
    args = timesteps[:, None].float() * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 == 1 else emb


def dropout_keep_masks(key: Key, shapes: Sequence[Tuple[int, ...]], rate: float,
                       device) -> List[torch.Tensor]:
    """The keep masks (True with probability 1 − ``rate``) of a train
    step's dropouts, one per shape, from the step's ``key``."""
    gen = key_generator((*key, DROPOUT_TAG), device)
    return [torch.rand(s, generator=gen, device=device) < 1.0 - rate for s in shapes]


class FilmResBlock(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, cond_dim: int, dropout: float = 0.1,
                 num_groups: int = 32, *, generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        self.res_conv = Conv(in_chan, out_chan, 1, **g) if in_chan != out_chan else None
        self.norm1 = GroupNorm(num_groups_for(num_groups, in_chan), in_chan)
        self.conv1 = Conv(in_chan, out_chan, 3, padding=1, **g)
        self.cond = Dense(cond_dim, 2 * out_chan, **g)
        self.norm2 = GroupNorm(num_groups_for(num_groups, out_chan), out_chan)
        self.conv2 = Conv(out_chan, out_chan, 3, padding=1, **g)
        self.dropout = dropout

    def forward(self, x, cond_emb, keep: Optional[torch.Tensor] = None):
        residual = x if self.res_conv is None else self.res_conv(x)
        h = self.conv1(F.silu(self.norm1(x)))
        scale, shift = self.cond(F.silu(cond_emb))[:, None, None, :].chunk(2, dim=-1)
        h = F.silu(self.norm2(h) * (1 + scale) + shift)
        if keep is not None:
            # flax's Dropout: kept values scaled by 1 / (1 - rate).
            h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
        return self.conv2(h) + residual


class PUNetGCFD(nn.Module):
    """``forward(x, timesteps, case_params, keep_masks=None) → (B, H, W,
    out_channels)``: x (B, H, W, in_channels), timesteps (B,) integers,
    case_params (B, n_case_params). Parameters are drawn from
    ``generator`` on the CPU, then moved to ``device``."""

    def __init__(self, in_channels: int, out_channels: int, base_channels: int = 64,
                 n_case_params: int = 5, channel_mults: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, dropout: float = 0.1, num_groups_norm: int = 32, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        g = dict(generator=generator)
        b, ted = base_channels, 4 * base_channels
        self.base_channels = b
        self.levels, self.num_res_blocks, self.dropout = len(channel_mults), num_res_blocks, dropout
        self.t_dense1, self.t_dense2 = Dense(b, ted, **g), Dense(ted, ted, **g)
        self.c_dense1, self.c_dense2 = Dense(n_case_params, ted, **g), Dense(ted, ted, **g)
        self.conv_in = Conv(in_channels, b, 3, padding=1, **g)
        blocks, downs, ups = [], [], []
        self._block_outs = []  # (level, channels) of each block, in call order

        def block(in_chan, out_chan, level):
            blocks.append(FilmResBlock(in_chan, out_chan, 2 * ted, dropout, num_groups_norm, **g))
            self._block_outs.append((level, out_chan))

        skips, cur = [b], b
        for i, mult in enumerate(channel_mults):
            for _ in range(num_res_blocks):
                block(cur, b * mult, i)
                cur = b * mult
                skips.append(cur)
            if i != self.levels - 1:
                downs.append(Conv(cur, cur, 3, padding=1, stride=2, **g))
                skips.append(cur)
        for _ in range(2):
            block(cur, cur, self.levels - 1)
        for i, mult in enumerate(reversed(channel_mults)):
            if i != 0:
                ups.append(Conv(cur, cur, 3, padding=1, **g))
            for _ in range(num_res_blocks + 1):
                block(cur + skips.pop(), b * mult, self.levels - 1 - i)
                cur = b * mult
        assert not skips, f"{len(skips)} unused skip connections"
        self.res_blocks, self.downs, self.ups = (nn.ModuleList(m) for m in (blocks, downs, ups))
        self.norm_out = GroupNorm(num_groups_for(num_groups_norm, cur), cur)
        self.conv_out = Conv(cur, out_channels, 3, padding=1, **g)
        self.to(device)

    def dropout_shapes(self, x_shape) -> List[Tuple[int, int, int, int]]:
        """The shape of each FilmResBlock's dropout input, in call order,
        for an input of ``x_shape``."""
        B, H, W = x_shape[:3]
        sizes = [(H, W)]
        for _ in range(self.levels - 1):
            h, w = sizes[-1]
            sizes.append((-(-h // 2), -(-w // 2)))
        return [(B, *sizes[level], c) for level, c in self._block_outs]

    def forward(self, x, timesteps, case_params, keep_masks: Optional[Sequence] = None):
        t_emb = self.t_dense2(F.silu(self.t_dense1(timestep_embedding(timesteps,
                                                                      self.base_channels))))
        c_emb = self.c_dense2(F.silu(self.c_dense1(case_params)))
        cond = torch.cat([t_emb, c_emb], dim=-1)
        masks = iter(keep_masks) if keep_masks is not None else itertools.repeat(None)
        blocks, downs, ups = iter(self.res_blocks), iter(self.downs), iter(self.ups)

        h = self.conv_in(x)
        skips = [h]
        for i in range(self.levels):
            for _ in range(self.num_res_blocks):
                h = next(blocks)(h, cond, next(masks))
                skips.append(h)
            if i != self.levels - 1:
                h = next(downs)(h)
                skips.append(h)
        for _ in range(2):
            h = next(blocks)(h, cond, next(masks))
        for i in range(self.levels):
            if i != 0:
                # Nearest x2, cropped to the skip's shape: the encoder maps
                # an odd W to ceil(W/2), so the repeat overshoots by one.
                B, H, W, C = h.shape
                sh, sw = skips[-1].shape[1:3]
                h = h[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(
                    B, 2 * H, 2 * W, C)[:, :sh, :sw]
                h = next(ups)(h)
            for _ in range(self.num_res_blocks + 1):
                h = next(blocks)(torch.cat([h, skips.pop()], dim=-1), cond, next(masks))
        return self.conv_out(F.silu(self.norm_out(h)))
