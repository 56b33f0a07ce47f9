"""Shared model pieces (port of ``cfdbench_tpu/models/common.py``, the
parts the FNO uses). NHWC tensors; ``nn.Linear`` weight layout.

Not ported: ``dense_thin``, a TPU workaround for the backward of the
head's fc2; ``gelu_exact``, whose rational erf was a TPU workaround for
a missing erf lowering — the port uses ``F.gelu``, whose default is the
true-erf GELU (the two differ by at most 1.5e-7); and
``broadcast_params_to_channels``, since the FNO's decomposed lift
never builds the broadcast case-parameter planes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def torch_kernel_init(weight: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) in place — the torch
    Linear/Conv2d default (kaiming_uniform with a=sqrt(5)), drawn from
    ``generator``; fan_in is ``weight.shape[1]`` times the receptive
    field (torch's ``(out, in, ...)`` layout)."""
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    bound = fan_in ** -0.5
    return weight.uniform_(-bound, bound, generator=generator)


def torch_bias_init(bias: torch.Tensor, fan_in: int,
                    generator: torch.Generator) -> torch.Tensor:
    bound = fan_in ** -0.5
    return bias.uniform_(-bound, bound, generator=generator)


class Dense(nn.Module):
    """``nn.Linear`` with its default init distributions drawn from an
    explicit generator. ``weight`` is ``(out, in)``."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator):
        super().__init__()
        w = torch.empty((out_features, in_features), dtype=torch.float32)
        b = torch.empty((out_features,), dtype=torch.float32)
        self.weight = nn.Parameter(torch_kernel_init(w, generator))
        self.bias = nn.Parameter(torch_bias_init(b, in_features, generator))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def coord_channels(batch: int, h: int, w: int, *, dtype=torch.float32,
                   device=None):
    """(B, H, W, 2): x = linspace over rows, y = linspace over columns."""
    gx = torch.linspace(0.0, 1.0, h, dtype=dtype, device=device)
    gy = torch.linspace(0.0, 1.0, w, dtype=dtype, device=device)
    grid = torch.stack(
        [gx[:, None].expand(h, w), gy[None, :].expand(h, w)], dim=-1
    )
    return grid[None].expand(batch, h, w, 2)


def ensure_mask(mask, batch: int, h: int, w: int, *, device=None):
    """None → all-ones; (B, H, W) → (B, H, W, 1). Contiguous."""
    if mask is None:
        return torch.ones((batch, h, w, 1), dtype=torch.float32, device=device)
    if mask.dim() == 3:
        mask = mask[..., None]
    return mask.contiguous()
