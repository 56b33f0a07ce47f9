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
- Under bfloat16 weights and input (``--use_mixed_precision``) the
  timestep embedding stays float32, so the conditioning, every FiLM
  output and, from the first block's FiLM on, the network compute in
  float32 on the bfloat16-rounded weights, as the JAX model does; the
  cross-attention's products take their operands' common dtype.

Dropout runs only where the caller passes keep masks, one per
FilmResBlock in call order (:func:`dropout_keep_masks`): the task draws
them from the step's key before the forward, so a recomputed forward
(gradient checkpointing) applies the same masks. With
``cross_attention`` (the latent diffusion models v1 and v2) a
:class:`CrossAttnBlock` runs between the two middle blocks, its keys and
values read from a ``context`` sequence. Convolutions are cuDNN calls on
the card; no TPU kernel covers this model.

Under spatial sharding (``--shard_spatial 1``, ``sp`` the model axis over
which the grid rows split; pixel diffusion's network, and the latent
models', on the split of their latents that the caller passes) a rank runs
the network on its rows: the 3x3 convolutions
take a halo of a row from the neighbouring ranks, the GroupNorms sum each
sample's statistics over the model ranks (``models/common.py``). Each
level tracks its split (``parallel/spatial.py::Rows``): a stride-2 ``down``
reads its level's rows resharded so that each rank holds whole row pairs,
and its output split is that one halved, rounded up; the nearest repeat of
the decoder, cropped to the skip's rows, is resharded to the skip's split.
The keep masks, drawn for the global grid, are sliced to each level's rows.
A deep level may leave a rank without a row (latents of 4 rows over 4
ranks): it runs the level on its empty rows, in its exchanges and sums.
The cross-attention's queries are the rank's rows of the mid level; its
keys and values are read from the ``context`` that the caller passes,
every rank's tokens (``models/diffusion.py`` gathers them).
"""

from __future__ import annotations

import itertools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import promote
from ..parallel.spatial import Rows, active, reshard, to_pairs
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

    def forward(self, x, cond_emb, keep: Optional[torch.Tensor] = None, rows=None):
        residual = x if self.res_conv is None else self.res_conv(x)
        h = self.conv1(F.silu(self.norm1(x)), rows)
        scale, shift = self.cond(F.silu(cond_emb))[:, None, None, :].chunk(2, dim=-1)
        h = F.silu(self.norm2(h) * (1 + scale) + shift)
        if keep is not None:
            # flax's Dropout: kept values scaled by 1 / (1 - rate).
            h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
        return self.conv2(h, rows) + residual


class CrossAttnBlock(nn.Module):
    """Spatial queries over a conditioning sequence (``punetg.py:83-110``):
    GroupNorm (eps 1e-6), q from the normalised field, k and v from the
    ``context`` (B, S, context_dim), all biased linear layers;
    ``max(1, C // 8)`` heads of ``C // heads`` dims (a head width of 8, the
    reference's ``attention_head_dim``; the docstring of the JAX
    ``LatentDiffusionCfdModel2`` says 4 heads, its code does this), then
    an output layer, added to the input."""

    HEAD_DIM = 8

    def __init__(self, channels: int, context_dim: int, *, generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        self.group_norm = GroupNorm(num_groups_for(32, channels), channels)
        self.to_q = Dense(channels, channels, **g)
        self.to_k = Dense(context_dim, channels, **g)
        self.to_v = Dense(context_dim, channels, **g)
        self.to_out = Dense(channels, channels, **g)
        self.heads = max(1, channels // self.HEAD_DIM)

    def forward(self, x, context):
        B, H, W, C = x.shape
        nh = self.heads
        hd = C // nh
        q = self.to_q(self.group_norm(x).reshape(B, H * W, C)).reshape(B, H * W, nh, hd)
        k = self.to_k(context).reshape(B, -1, nh, hd)
        v = self.to_v(context).reshape(B, -1, nh, hd)
        logits = torch.einsum("bqnd,bknd->bnqk", *promote(q, k)) / hd ** 0.5
        out = torch.einsum("bnqk,bknd->bqnd", *promote(torch.softmax(logits, dim=-1), v))
        return x + self.to_out(out.reshape(B, H * W, C)).reshape(B, H, W, C)


class PUNetGCFD(nn.Module):
    """``forward(x, timesteps, case_params, keep_masks=None, context=None)
    → (B, H, W, out_channels)``: x (B, H, W, in_channels), timesteps (B,)
    integers, case_params (B, n_case_params); ``context`` (B, S,
    ``context_dim``) when built with ``cross_attention``. Parameters are
    drawn from ``generator`` on the CPU, then moved to ``device``. Under
    spatial sharding x is a rank's rows of the even split, or of ``rows``
    where given (``parallel/spatial.py::Rows``), and each keep mask covers
    its level's global rows."""

    sp = None  # the model axis the grid rows split over

    def __init__(self, in_channels: int, out_channels: int, base_channels: int = 64,
                 n_case_params: int = 5, channel_mults: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, dropout: float = 0.1, num_groups_norm: int = 32,
                 cross_attention: bool = False, context_dim: int = 0, *,
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
        block(cur, cur, self.levels - 1)
        self.cross_attn = CrossAttnBlock(cur, context_dim, **g) if cross_attention else None
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

    def forward(self, x, timesteps, case_params, keep_masks: Optional[Sequence] = None,
                context: Optional[torch.Tensor] = None, rows: Optional[Rows] = None):
        # float32 (or wider weights' dtype, through the Dense) under
        # bfloat16 weights too, as in the JAX package, where it lifts the
        # conditioning, and from the first FiLM on the network, to float32.
        emb = timestep_embedding(timesteps, self.base_channels)
        t_emb = self.t_dense2(F.silu(self.t_dense1(emb)))
        c_emb = self.c_dense2(F.silu(self.c_dense1(case_params)))
        cond = torch.cat([t_emb, c_emb], dim=-1)
        masks = iter(keep_masks) if keep_masks is not None else itertools.repeat(None)
        blocks, downs, ups = iter(self.res_blocks), iter(self.downs), iter(self.ups)
        if rows is None and active(self.sp):
            rows = Rows.of(x.shape[1], self.sp)
        base = rows

        def block(h):
            keep = next(masks)
            if keep is not None and rows is not None:
                keep = keep.narrow(1, rows.r0, rows.h)
            return next(blocks)(h, cond, keep, rows)

        h = self.conv_in(x, rows)
        skips = [h]
        for i in range(self.levels):
            for _ in range(self.num_res_blocks):
                h = block(h)
                skips.append(h)
            if i != self.levels - 1:
                h, rows = to_pairs(h, rows)
                h = next(downs)(h, rows)
                rows = None if rows is None else rows.halved(ceil=True)
                skips.append(h)
        h = block(h)
        if self.cross_attn is not None and context is not None:
            h = self.cross_attn(h, context)
        h = block(h)
        splits = self._level_splits(base)
        for i in range(self.levels):
            if i != 0:
                # Nearest x2, cropped to the skip's shape: the encoder maps
                # an odd W to ceil(W/2), so the repeat overshoots by one.
                B, H, W, C = h.shape
                sh, sw = skips[-1].shape[1:3]
                skip_rows = splits[self.levels - 1 - i]
                if rows is not None:
                    up = rows.doubled(skip_rows.H)
                    sh = up.h
                h = h[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(
                    B, 2 * H, 2 * W, C)[:, :sh, :sw]
                if rows is not None:
                    h, rows = reshard(h, up, skip_rows), skip_rows
                h = next(ups)(h, rows)
            for _ in range(self.num_res_blocks + 1):
                h = block(torch.cat([h, skips.pop()], dim=-1))
        return self.conv_out(F.silu(self.norm_out(h)), rows)

    def _level_splits(self, rows):
        """Each level's split under spatial sharding (None without): the
        input's split, then each stride-2 ``down``'s output split."""
        if rows is None:
            return [None] * self.levels
        return rows.halvings(self.levels - 1, ceil=True)
