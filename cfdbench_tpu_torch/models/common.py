"""Shared model pieces (port of ``cfdbench_tpu/models/common.py``). NHWC
tensors; ``nn.Linear`` and ``nn.Conv2d`` weight layouts, so that a
reference CFDBench ``state_dict`` loads by name.

Not ported: ``dense_thin``, a TPU workaround for the backward of the
FNO head's fc2; ``gelu_exact``, whose rational erf was a TPU workaround
for a missing erf lowering — the port uses ``F.gelu``, whose default is
the true-erf GELU (the two differ by at most 1.5e-7).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def torch_kernel_init(weight: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) in place — the torch
    Linear/Conv2d default (kaiming_uniform with a=sqrt(5)), drawn from
    ``generator``; fan_in is ``weight.shape[1]`` times the receptive
    field (torch's ``(out, in, ...)`` layout; for a transposed conv's
    ``(in, out, kh, kw)`` that is out·kh·kw, as torch computes it)."""
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


class Conv(nn.Module):
    """NHWC 2-D convolution with torch-default init drawn from
    ``generator``; ``weight`` is ``(out, in, k, k)``. With
    ``replicate_pad`` the border is padded by edge replication (the
    reference's ``padding_mode="replicate"``), else with zeros."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int = 3,
                 padding: int = 0, replicate_pad: bool = False, stride: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        k = kernel_size
        w = torch.empty((out_chan, in_chan, k, k), dtype=torch.float32)
        b = torch.empty((out_chan,), dtype=torch.float32)
        self.weight = nn.Parameter(torch_kernel_init(w, generator))
        self.bias = nn.Parameter(torch_bias_init(b, in_chan * k * k, generator))
        self.padding, self.replicate_pad, self.stride = padding, replicate_pad, stride

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # an NCHW view of the NHWC tensor
        p = self.padding
        if self.replicate_pad and p:
            x = F.pad(x, (p, p, p, p), mode="replicate")
            p = 0
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=p).permute(0, 2, 3, 1)


def num_groups_for(groups: int, channels: int) -> int:
    """Largest divisor of ``channels`` that is <= ``groups``: the GroupNorm
    group count of the PUNetG (and VAE) stacks."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    """GroupNorm over the channels of an NHWC tensor: ``torch.group_norm``
    on its NCHW view. ``weight`` and ``bias`` are flax's ``scale`` and
    ``bias``. flax computes the variance as E[x²] − E[x]²
    (``use_fast_variance``), torch in two passes; the PUNetG's forwards
    and gradients agree with flax's within 2e-5 and 1e-5 of their max
    (``tests/test_torch_diffusion.py``)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if x.device.type == "cpu" and not x.requires_grad:
            # torch's CPU backward of a channels-last group norm whose input
            # needs no gradient (its weights do) crashes; a contiguous one
            # does not.
            x = x.contiguous()
        # The ATen op, not F.group_norm, whose check refuses a group of one
        # value in training (a 1x1 field at one channel a group), which flax
        # normalises to its bias.
        return torch.group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps).permute(0, 2, 3, 1)


class MaxPool2(nn.Module):
    """2x2 max pool, stride 2, over the H and W of an NHWC tensor; odd
    edges are dropped (flax's and torch's VALID pooling)."""

    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


_ACTS = {
    "relu": nn.ReLU,
    "tanh": nn.Tanh,
    # The reference's "gelu" is torch's F.gelu, the exact erf.
    "gelu": nn.GELU,
    "swish": nn.SiLU,
}


def norm_act(act: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Scale-invariant activation (``src/models/act_fn.py:33-47``): each
    sample (the leading axis) is normalised over all its other axes with
    the unbiased std, activated, and de-normalised."""
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    n = math.prod(x.shape[1:])
    std = ((x - mean).square().sum(dim=dims, keepdim=True) / max(n - 1, 1)).sqrt()
    return act((x - mean) / std) * std + mean


class NormAct(nn.Module):
    """:func:`norm_act` of ``act``, as a module without parameters."""

    def __init__(self, act: nn.Module):
        super().__init__()
        self.act = act

    def forward(self, x):
        return norm_act(self.act, x)


def get_act_fn(name: str, norm: bool = False) -> nn.Module:
    """Mirror of ``src/models/act_fn.py:5-18``, as a module; ``norm``
    wraps it in :class:`NormAct`."""
    if name not in _ACTS:
        raise ValueError(f"Unknown activation function: {name}")
    act = _ACTS[name]()
    return NormAct(act) if norm else act


class Mlp(nn.Module):
    """Generic fully connected stack (reference ``Ffn``,
    ``src/models/ffn.py:12-35``): Linear + act between all dims, the last
    Linear without act unless ``act_on_output``. ``layers`` is the
    reference's ``Sequential``, a Linear at every even index and an
    activation (without parameters) at every odd one."""

    def __init__(self, dims: Sequence[int], act_name: str = "relu", act_norm: bool = False,
                 act_on_output: bool = False, *, generator: torch.Generator):
        super().__init__()
        dims = list(dims)
        layers = []
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            if i:
                layers.append(get_act_fn(act_name, act_norm))
            layers.append(Dense(d_in, d_out, generator=generator))
        if act_on_output:
            layers.append(get_act_fn(act_name, act_norm))
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


def broadcast_params_to_channels(case_params, h: int, w: int):
    """(B, P) → (B, H, W, P) constant channel planes (a broadcast view)."""
    return case_params[:, None, None, :].expand(case_params.shape[0], h, w,
                                                case_params.shape[1])


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
