"""Seeded inputs, made on the device: flow fields, geometry masks and case
parameters in the layout of the program's datasets (``(N, H, W, C)``
float32, masks ``(N, H, W, 1)``, case parameters ``(N, P)``).

A field is a sum of the lowest K x K sine modes of the cavity with random
amplitudes falling as 1/(kx ky); its label is the same modes one step on,
each damped as diffusion would damp it. A mask is 1 but for one rectangular
obstacle of 4 to 16 cells a side. Case parameters are uniform in [0, 1), as
normalised ones are. Every draw comes from one generator on the device seeded
from the run's seed and a stream number, so the same seed gives the same
inputs.
"""

from __future__ import annotations

import math

import torch

from .reference.weights import seed_of

MODES = 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed * 1_000_003 + stream))
    return g


def _basis(H: int, W: int, device) -> torch.Tensor:
    """(K*K, H*W): sin(pi kx x) sin(pi ky y) on the cell centres."""
    k = torch.arange(1, MODES + 1, device=device, dtype=torch.float32)
    x = (torch.arange(H, device=device, dtype=torch.float32) + 0.5) / H
    y = (torch.arange(W, device=device, dtype=torch.float32) + 0.5) / W
    sx = torch.sin(math.pi * k[:, None] * x[None])  # (K, H)
    sy = torch.sin(math.pi * k[:, None] * y[None])  # (K, W)
    return (sx[:, None, :, None] * sy[None, :, None, :]).reshape(MODES * MODES, H * W)


def flow_pairs(n: int, H: int, W: int, channels: int, g: torch.Generator, device):
    """``(inputs, labels)``, each ``(n, H, W, channels)``."""
    k = torch.arange(1, MODES + 1, device=device, dtype=torch.float32)
    decay = 1.0 / (k[:, None] * k[None, :]).reshape(-1)  # (K*K,)
    damp = torch.exp(-0.05 * (k[:, None] ** 2 + k[None, :] ** 2)).reshape(-1)
    coef = (torch.rand((n, channels, MODES * MODES), generator=g, device=device) * 2 - 1) * decay
    basis = _basis(H, W, device)
    inputs = (coef @ basis).reshape(n, channels, H, W).permute(0, 2, 3, 1).contiguous()
    labels = ((coef * damp) @ basis).reshape(n, channels, H, W).permute(0, 2, 3, 1).contiguous()
    return inputs, labels


def masks(n: int, H: int, W: int, g: torch.Generator, device) -> torch.Tensor:
    lo, hi = min(4, H // 2), min(16, H // 2)
    size = torch.randint(lo, hi + 1, (n, 2), generator=g, device=device)
    corner = (torch.rand((n, 2), generator=g, device=device)
              * (torch.tensor([H, W], device=device) - size)).long()
    r = torch.arange(H, device=device)[None, :]
    c = torch.arange(W, device=device)[None, :]
    inside_r = (r >= corner[:, :1]) & (r < corner[:, :1] + size[:, :1])  # (n, H)
    inside_c = (c >= corner[:, 1:]) & (c < corner[:, 1:] + size[:, 1:])  # (n, W)
    hole = inside_r[:, :, None] & inside_c[:, None, :]
    return (~hole).float()[..., None]


def case_params(n: int, p: int, g: torch.Generator, device) -> torch.Tensor:
    return torch.rand((n, p), generator=g, device=device)
