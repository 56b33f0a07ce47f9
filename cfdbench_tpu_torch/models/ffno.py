"""Factorised Fourier Neural Operator (port of ``cfdbench_tpu/models/ffno.py``;
Tran et al., arXiv:2111.13802).

Each block sums two separable 1-D spectral convs, along H and along W,
then a two-layer feedforward (width 2C, GELU) inside a residual branch:
``x + dense1(GELU(dense0(conv_h(x) + conv_w(x))))``. The lift and the
head follow the FNO's channel contract: ``fc0`` over the concatenated
[inputs ‖ mask ‖ coords ‖ case-parameter planes], as the JAX model
builds it, and fc1(→128) → GELU → fc2(→out) → ×mask. GELU is ``F.gelu``,
the true erf.

In bfloat16 the model keeps the JAX package's promotion: the 1-D
spectral conv returns float32 (``ops/spectral.py``), so from the first
block's feedforward on the model runs in float32 on its bfloat16-rounded
weights and returns float32 (ROADMAP.md C).

The JAX package runs every op of this model as plain XLA, its head too
(not the Pallas head), so the port runs ``torch.fft`` and ``F.linear``
calls on either device and launches no kernel of its own.

Under spatial sharding (``--shard_spatial 1``, ``sp`` the model axis over
which the grid rows split) a rank runs the model on its rows: the lift
on its rows of the global coordinates, the row-axis conv as a sum of
the ranks' partial modes (``ops/spectral.py::spectral_conv1d``), the
W-axis conv, the feedforward and the head on its rows.

No reference torch model exists; the ``state_dict`` keys follow the
flax modules: ``fc0`` (``Dense_0``), ``blocks.{i}.weights_h``/
``weights_w``/``dense0``/``dense1`` (``FfnoBlock_i``'s params and its
``Dense_0``/``Dense_1``), ``fc1``/``fc2`` (``Dense_1``/``Dense_2``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spectral import init_spectral_weights_1d, spectral_conv1d
from .common import Dense, broadcast_params_to_channels, coord_channels, ensure_mask
from .fno import HEAD_WIDTH


FF_FACTOR = 2  # the feedforward's width over the block's


class FfnoBlock(nn.Module):
    def __init__(self, channels: int, modes1: int, modes2: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        self.weights_h = nn.Parameter(init_spectral_weights_1d(generator, channels, modes1))
        self.weights_w = nn.Parameter(init_spectral_weights_1d(generator, channels, modes2))
        self.dense0 = Dense(channels, FF_FACTOR * channels, generator=generator)
        self.dense1 = Dense(FF_FACTOR * channels, channels, generator=generator)

    sp = None  # the model axis the grid rows split over

    def forward(self, x):
        y = (spectral_conv1d(x, self.weights_h, self.modes1, axis=1, rows=self.sp)
             + spectral_conv1d(x, self.weights_w, self.modes2, axis=2))
        return x + self.dense1(F.gelu(self.dense0(y)))


class Ffno2d(nn.Module):
    """Autoregressive FFNO: ``forward(inputs, case_params, mask) → preds``,
    inputs (B, H, W, in_chan), case_params (B, P), mask (B, H, W, 1),
    (B, H, W) or None; returns (B, H, W, out_chan), masked. Parameters
    are drawn from ``generator`` on the CPU, then moved to ``device``."""

    def __init__(self, in_chan: int = 2, out_chan: int = 2, n_case_params: int = 5,
                 num_layers: int = 4, modes1: int = 16, modes2: int = 16,
                 hidden_dim: int = 32, *, generator: torch.Generator, device=None):
        super().__init__()
        self.out_chan = out_chan
        self.fc0 = Dense(in_chan + 3 + n_case_params, hidden_dim, generator=generator)
        self.blocks = nn.ModuleList(
            FfnoBlock(hidden_dim, modes1, modes2, generator=generator)
            for _ in range(num_layers)
        )
        self.fc1 = Dense(hidden_dim, HEAD_WIDTH, generator=generator)
        self.fc2 = Dense(HEAD_WIDTH, out_chan, generator=generator)
        self.to(device)

    sp = None  # the model axis the grid rows split over

    def forward(self, inputs, case_params, mask=None):
        B, H, W, _ = inputs.shape
        mask = ensure_mask(mask, B, H, W, device=inputs.device)
        coords = coord_channels(B, H, W, dtype=inputs.dtype, device=inputs.device, rows=self.sp)
        x = self.fc0(torch.cat([
            inputs, mask, coords,
            broadcast_params_to_channels(case_params, H, W)], dim=-1))
        for block in self.blocks:
            x = block(x)
        return self.fc2(F.gelu(self.fc1(x))) * mask
