"""U-Net autoregressive baseline (port of ``cfdbench_tpu/models/unet.py``,
the reference's ``src/models/unet.py``).

A 4-down/4-up U-Net of DoubleConv blocks (conv3x3 with replicate
padding → BatchNorm → ReLU, twice); case parameters go in either as
input channels (``insert_case_params_at="input"``) or added at the
bottleneck through a Linear (``"hidden"``); the mask is one more input
channel; the prediction is the input plus the network's output, times
the mask. Submodules carry the reference's ``state_dict`` names
(``in_conv``, ``down{i}.maxpool_conv.1``, ``up{i}.up``, ``up{i}.conv``,
``case_params_fc``, ``out_conv.conv``). Convolutions and products are
cuDNN / cuBLAS calls on the card (no TPU kernel covers them).

Under spatial sharding (``--shard_spatial 1``, ``sp`` the model axis over
which the grid rows split) a rank runs the network on its rows, at any
row count that divides over the model axis, as JAX's XLA runs it: the
3x3 convolutions take a halo of one row from the neighbouring ranks
(``models/common.py::Conv``), BatchNorm sums over every rank of the world
(its ``mesh`` is the mesh's ``cells``, the element counts summed too). Each
level's output is resharded so that every rank holds whole row pairs
(``parallel/spatial.py::Rows.pairs``): the pooling windows stay within a
rank, the level's skip keeps that split, and ``Up``'s transposed conv and
its pad (the odd row at the grid's bottom, on the last rank) give the
skip's split back, or are resharded to it. The output is resharded to
the even split the batch came in. A deep level may leave a rank without a
row (16 rows over 2 ranks: the bottleneck's one row on the first), as
XLA's partitioner computes it too: that rank's convolutions, pooling and
transposed conv return its empty output and it still enters the level's
halos, BatchNorm sums and reshards (``models/common.py::conv_rows``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import common_dtype, promote
from ..parallel.mesh import SINGLE
from ..parallel.spatial import Rows, active, reshard, to_pairs
from .common import (
    Conv,
    Dense,
    MaxPool2,
    broadcast_params_to_channels,
    ensure_mask,
    torch_bias_init,
    torch_kernel_init,
)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over the channels of an NHWC tensor, with the JAX
    package's (flax's) running statistics: in training the batch's
    *biased* variance, the one it normalises with, goes into
    ``running_var``. ``nn.BatchNorm2d`` stores the unbiased one, n/(n-1)
    times larger (ROADMAP.md C), so every eval-mode output after training
    would differ. Momentum 0.1 (flax's 0.9), eps 1e-5. The buffers keep
    ``nn.BatchNorm2d``'s names, so a reference checkpoint loads.

    As flax's, it returns the common dtype of x and its weights; in
    training it reduces and normalises in float32 at least, so a bfloat16
    x (mixed precision) updates the float32 running statistics with
    float32 batch statistics. In evaluation it computes in the common
    dtype of x, the statistics and the weights: bfloat16 throughout in the
    bfloat16 rollout, which casts the statistics too.

    Under data parallelism (``mesh``, set by ``trainer_auto.use_mesh``) x
    is this rank's block of the global batch, and training normalises with
    the global batch's statistics, weight-0 padding rows included, as the
    JAX package does over its sharded batch: Σx and Σx² are summed over
    the ranks, differentiably (``nn.SyncBatchNorm``'s job, in
    flax's numerics). Under spatial sharding ``mesh`` is the mesh's
    ``cells``: a rank's block of rows of its block of the batch, the sums
    and the count over every rank of the world (the counts summed with
    the sums: a level's ranks may hold unequal rows)."""

    mesh = SINGLE

    def forward(self, x):
        out = common_dtype(x, self.weight, self.bias)
        if self.training:
            x = x.to(torch.promote_types(out, torch.float32))
            C = x.shape[-1]
            sums = self.mesh.sum(torch.cat([x.sum(dim=(0, 1, 2)), (x * x).sum(dim=(0, 1, 2)),
                                            x.new_full((1,), x.numel() // C)]))
            count = sums[-1]
            mean = sums[:C] / count
            var = torch.clamp(sums[C:2 * C] / count - mean * mean, min=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(out)


def _conv_bn_relu(in_chan: int, out_chan: int, generator) -> nn.Sequential:
    return nn.Sequential(
        Conv(in_chan, out_chan, 3, padding=1, replicate_pad=True, generator=generator),
        BatchNorm(out_chan, eps=1e-5, momentum=0.1),
        nn.ReLU(),
    )


class DoubleConv(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, *, generator: torch.Generator):
        super().__init__()
        self.conv1 = _conv_bn_relu(in_chan, out_chan, generator)
        self.conv2 = _conv_bn_relu(out_chan, out_chan, generator)

    def forward(self, x, rows=None):
        for conv, norm, act in (self.conv1, self.conv2):
            x = act(norm(conv(x, rows)))
        return x


class Down(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, *, generator: torch.Generator):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            MaxPool2(), DoubleConv(in_chan, out_chan, generator=generator))

    def forward(self, x, rows=None):
        """``rows``: x's split, whose ranks hold whole row pairs; the output
        is on that split halved."""
        pool, conv = self.maxpool_conv
        return conv(pool(x, rows), None if rows is None else rows.halved(ceil=False))


class ConvTranspose2x2(nn.Module):
    """2x upsampling by a 2x2, stride-2 transposed conv, NHWC. ``weight``
    is torch's ``(in, out, 2, 2)``, whose default init takes its fan-in
    from ``out``·4, not ``in``·4 (JAX ``unet.py:63-73``)."""

    OUT_AXIS = 1  # the weight is (in, out, 2, 2)

    def __init__(self, in_chan: int, out_chan: int, *, generator: torch.Generator):
        super().__init__()
        w = torch.empty((in_chan, out_chan, 2, 2), dtype=torch.float32)
        b = torch.empty((out_chan,), dtype=torch.float32)
        self.weight = nn.Parameter(torch_kernel_init(w, generator))
        self.bias = nn.Parameter(torch_bias_init(b, out_chan * 4, generator))

    def forward(self, x):
        x, w, b = promote(x.permute(0, 3, 1, 2), self.weight, self.bias)
        empty = not x.shape[2]  # a rank without rows: as common.conv_rows
        y = F.conv_transpose2d(F.pad(x, (0, 0, 0, 1)) if empty else x, w, b, stride=2)
        return (y[:, :, :0] if empty else y).permute(0, 2, 3, 1)


class Up(nn.Module):
    """Upsample, zero-pad to the skip's size — ``(d // 2, d - d // 2)``
    on each axis, for odd grids — concatenate [skip, upsampled], then a
    DoubleConv (the reference's ``bilinear=False``)."""

    def __init__(self, in_chan: int, out_chan: int, *, generator: torch.Generator):
        super().__init__()
        self.up = ConvTranspose2x2(in_chan, in_chan // 2, generator=generator)
        self.conv = DoubleConv(in_chan, out_chan, generator=generator)

    def forward(self, x1, x2, rows=None, skip_rows=None):
        """``rows`` and ``skip_rows``: the splits of x1 and of the skip x2
        under spatial sharding, else None."""
        x1 = self.up(x1)
        dw = x2.shape[2] - x1.shape[2]
        if rows is None:
            dh = x2.shape[1] - x1.shape[1]
            if dh or dw:
                x1 = F.pad(x1, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        else:
            # The skip's rows are 2 h or 2 h + 1 (a pool drops an odd row):
            # the pad is (0, 1) rows, the last rank's.
            up = rows.doubled(skip_rows.H)
            dh = up.h - x1.shape[1]
            if dh or dw:
                x1 = F.pad(x1, (0, 0, dw // 2, dw - dw // 2, 0, dh))
            x1 = reshard(x1, up, skip_rows)
        return self.conv(torch.cat([x2, x1], dim=-1), skip_rows)


class OutConv(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv(in_chan, out_chan, 1, generator=generator)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """``forward(inputs, case_params, mask) → preds``: inputs
    (B, H, W, in_chan), case_params (B, P), mask (B, H, W[, 1]) or None;
    preds (B, H, W, out_chan), masked. Parameters are drawn from
    ``generator`` on the CPU, then moved to ``device``."""

    pointwise = False
    sp = None  # the model axis the grid rows split over

    def __init__(self, in_chan: int = 2, out_chan: int = 2, n_case_params: int = 5,
                 insert_case_params_at: str = "input", dim: int = 12, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if insert_case_params_at not in ("input", "hidden"):
            raise ValueError(f"insert_case_params_at {insert_case_params_at!r}: "
                             "choose input or hidden")
        self.out_chan = out_chan
        self.insert_case_params_at = insert_case_params_at
        d = dim
        first = in_chan + 1 + (n_case_params if insert_case_params_at == "input" else 0)
        self.in_conv = DoubleConv(first, d, generator=generator)
        self.down1 = Down(d, d * 2, generator=generator)
        self.down2 = Down(d * 2, d * 4, generator=generator)
        self.down3 = Down(d * 4, d * 8, generator=generator)
        self.down4 = Down(d * 8, d * 16, generator=generator)
        if insert_case_params_at == "hidden":
            self.case_params_fc = Dense(n_case_params, d * 16, generator=generator)
        self.up1 = Up(d * 16, d * 8, generator=generator)
        self.up2 = Up(d * 8, d * 4, generator=generator)
        self.up3 = Up(d * 4, d * 2, generator=generator)
        self.up4 = Up(d * 2, d, generator=generator)
        self.out_conv = OutConv(d, out_chan, generator=generator)
        self.to(device)

    def forward(self, inputs, case_params, mask=None):
        B, H, W, _ = inputs.shape
        residual = inputs[..., :self.out_chan]
        mask = ensure_mask(mask, B, H, W, device=inputs.device)
        parts = [inputs, mask]
        if self.insert_case_params_at == "input":
            parts.append(broadcast_params_to_channels(case_params, H, W))
        base = Rows.of(H, self.sp) if active(self.sp) else None
        x1, r1 = to_pairs(self.in_conv(torch.cat(parts, dim=-1), base), base)
        x2, r2 = to_pairs(*self._down(self.down1, x1, r1))
        x3, r3 = to_pairs(*self._down(self.down2, x2, r2))
        x4, r4 = to_pairs(*self._down(self.down3, x3, r3))
        x5, r5 = self._down(self.down4, x4, r4)
        if self.insert_case_params_at == "hidden":
            x5 = x5 + self.case_params_fc(case_params)[:, None, None, :]
        x = self.up1(x5, x4, r5, r4)
        x = self.up2(x, x3, r4, r3)
        x = self.up3(x, x2, r3, r2)
        x = self.up4(x, x1, r2, r1)
        return (reshard(self.out_conv(x), r1, base) + residual) * mask

    @staticmethod
    def _down(down, x, rows):
        return down(x, rows), None if rows is None else rows.halved(ceil=False)
