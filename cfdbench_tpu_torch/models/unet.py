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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
    ``nn.BatchNorm2d``'s names, so a reference checkpoint loads."""

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 1, 2))
            var = torch.clamp((x * x).mean(dim=(0, 1, 2)) - mean * mean, min=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


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

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Down(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, *, generator: torch.Generator):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            MaxPool2(), DoubleConv(in_chan, out_chan, generator=generator))

    def forward(self, x):
        return self.maxpool_conv(x)


class ConvTranspose2x2(nn.Module):
    """2x upsampling by a 2x2, stride-2 transposed conv, NHWC. ``weight``
    is torch's ``(in, out, 2, 2)``, whose default init takes its fan-in
    from ``out``·4, not ``in``·4 (JAX ``unet.py:63-73``)."""

    def __init__(self, in_chan: int, out_chan: int, *, generator: torch.Generator):
        super().__init__()
        w = torch.empty((in_chan, out_chan, 2, 2), dtype=torch.float32)
        b = torch.empty((out_chan,), dtype=torch.float32)
        self.weight = nn.Parameter(torch_kernel_init(w, generator))
        self.bias = nn.Parameter(torch_bias_init(b, out_chan * 4, generator))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=2)
        return y.permute(0, 2, 3, 1)


class Up(nn.Module):
    """Upsample, zero-pad to the skip's size — ``(d // 2, d - d // 2)``
    on each axis, for odd grids — concatenate [skip, upsampled], then a
    DoubleConv (the reference's ``bilinear=False``)."""

    def __init__(self, in_chan: int, out_chan: int, *, generator: torch.Generator):
        super().__init__()
        self.up = ConvTranspose2x2(in_chan, in_chan // 2, generator=generator)
        self.conv = DoubleConv(in_chan, out_chan, generator=generator)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dh = x2.shape[1] - x1.shape[1]
        dw = x2.shape[2] - x1.shape[2]
        if dh or dw:
            x1 = F.pad(x1, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=-1))


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
        x1 = self.in_conv(torch.cat(parts, dim=-1))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        if self.insert_case_params_at == "hidden":
            x5 = x5 + self.case_params_fc(case_params)[:, None, None, :]
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        return (self.out_conv(x) + residual) * mask
