"""ResNet autoregressive baseline (port of ``cfdbench_tpu/models/resnet.py``,
the reference's ``src/models/resnet.py``).

- ResidualBlock: conv(k, replicate pad) → dropout(0.2) → GELU → conv →
  + residual (a 1x1-conv projection ``res_conv`` where the channel
  counts differ). The reference defines BatchNorms but never calls them
  in its forward (``resnet.py:70-80``), so the port has none; their
  buffers in a reference checkpoint are not parameters of this model.
- Stack ``blocks``: an in-block (in + 1 + P → hidden, projected),
  ``num_blocks`` hidden blocks, an out-block (hidden → out, projected);
  the inner conv width is 64.
- forward: channels [u, v] ‖ mask ‖ case-parameter planes; the
  prediction is the network's output plus the input, times the mask.

Dropout runs in training only, and its masks come from the
``torch.Generator`` the caller passes: the trainer seeds one from
``(seed, global step)``, as the JAX package folds the step into its key
(``trainer_auto.py:188-194``), so a resumed run draws the masks a
straight run draws. The bits are not JAX's: no test can match the JAX
package's masks, only their rate and scale, and parity in training is
checked with dropout off in both packages.

Under spatial sharding (``--shard_spatial 1``, ``sp`` the model axis over
which the grid rows split) a rank runs the network on its rows: the
replicate-padded convolutions take a halo of ``padding`` rows from the
ranks above and below (``models/common.py::Conv``), from as many ranks as
hold them where a rank holds fewer rows than that, and the dropout masks
are drawn over the global (B, H, W, C) and sliced.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import SINGLE, DataMesh
from ..parallel.spatial import row_span, take_rows
from .common import Conv, broadcast_params_to_channels, ensure_mask

DROPOUT = 0.2


def dropout(x, rate: float, generator: torch.Generator, mesh: DataMesh = SINGLE, rows=None):
    """Zero each element with probability ``rate`` and scale the rest by
    1 / (1 - rate), with the keep mask drawn from ``generator`` (flax's
    ``nn.Dropout``): over the global batch, of which ``x`` is this rank's
    block, and sliced; under spatial sharding (``rows``) over the global
    grid too, of which ``x`` holds the rank's rows."""
    shape = list(mesh.global_shape(x.shape))
    shape[1] = row_span(x.shape[1], rows)[1]
    keep = torch.empty(shape, dtype=x.dtype, device=x.device)
    keep = take_rows(mesh.block(keep.bernoulli_(1.0 - rate, generator=generator)), rows)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


class ResidualBlock(nn.Module):
    mesh = SINGLE  # the data axis its dropout draws over (trainer_auto.use_mesh)
    sp = None  # the model axis the grid rows split over

    def __init__(self, in_chan: int, out_chan: int, hidden_chan: int = 64,
                 kernel_size: int = 7, padding: int = 3, use_1x1conv: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.res_conv = Conv(in_chan, out_chan, 1, generator=generator) if use_1x1conv else None
        self.conv1 = Conv(in_chan, hidden_chan, kernel_size, padding, replicate_pad=True,
                          generator=generator)
        self.conv2 = Conv(hidden_chan, out_chan, kernel_size, padding, replicate_pad=True,
                          generator=generator)

    def forward(self, x, generator=None):
        residual = x if self.res_conv is None else self.res_conv(x)
        x = self.conv1(x)
        if self.training:
            if generator is None:
                raise ValueError("ResidualBlock draws dropout masks in training: "
                                 "pass a torch.Generator")
            x = dropout(x, DROPOUT, generator, self.mesh, self.sp)
        return self.conv2(F.gelu(x)) + residual


class ResNet(nn.Module):
    """``forward(inputs, case_params, mask, generator) → preds``: inputs
    (B, H, W, in_chan), case_params (B, P), mask (B, H, W[, 1]) or None;
    preds (B, H, W, out_chan), masked. ``generator`` draws the dropout
    masks and is needed in training only. Parameters are drawn from
    ``generator`` (the init one) on the CPU, then moved to ``device``."""

    pointwise = False
    draws_in_training = True

    def __init__(self, in_chan: int = 2, out_chan: int = 2, n_case_params: int = 5,
                 hidden_chan: int = 32, num_blocks: int = 4, kernel_size: int = 7,
                 padding: int = 3, *, generator: torch.Generator, device=None):
        super().__init__()
        self.out_chan = out_chan
        k = dict(kernel_size=kernel_size, padding=padding, generator=generator)
        self.blocks = nn.ModuleList(
            [ResidualBlock(in_chan + 1 + n_case_params, hidden_chan, use_1x1conv=True, **k)]
            + [ResidualBlock(hidden_chan, hidden_chan, **k) for _ in range(num_blocks)]
            + [ResidualBlock(hidden_chan, out_chan, use_1x1conv=True, **k)]
        )
        self.to(device)

    def forward(self, inputs, case_params, mask=None, generator=None):
        B, H, W, _ = inputs.shape
        residual = inputs[..., :self.out_chan]
        mask = ensure_mask(mask, B, H, W, device=inputs.device)
        x = torch.cat([inputs, mask, broadcast_params_to_channels(case_params, H, W)], dim=-1)
        for block in self.blocks:
            x = block(x, generator)
        return (x + residual) * mask
