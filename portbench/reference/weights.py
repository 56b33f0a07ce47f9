"""Seeded weights, drawn on the device in one call and shared by the program
and the reference.

Every leaf is uniform between the bounds of CFDBench's initialisation, taken
from its name and shape alone: a spectral weight ``(2, 2, Cin, Cout, m1, m2)``
U(0, 1/(Cin Cout)) (``scale * torch.rand`` of ``fno2d.py``); a weight of two
or more dimensions, in torch's ``(out, in, ...)`` layout (a transposed
convolution's ``(in, out, kh, kw)`` included, as torch computes its fan-in),
U(-b, b) with b = fan_in^-1/2, fan_in the product of its dimensions after
the first; a bias the same as its weight's; a norm's one-dimensional scale 1
and its bias 0.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Shape = Tuple[int, ...]


def bounds(name: str, shapes: Dict[str, Shape]) -> Tuple[float, float]:
    """``(low, high)`` of the uniform draw of leaf ``name``."""
    shape = shapes[name]
    if name.endswith(".weights") and len(shape) == 6:
        return 0.0, 1.0 / (shape[2] * shape[3])
    if name.endswith(".weight"):
        if len(shape) == 1:
            return 1.0, 1.0
        b = math.prod(shape[1:]) ** -0.5
        return -b, b
    if name.endswith(".bias"):
        w = shapes[name[: -len("bias")] + "weight"]
        if len(w) == 1:
            return 0.0, 0.0
        b = math.prod(w[1:]) ** -0.5
        return -b, b
    raise ValueError(f"no initialisation rule for {name} {shape}")


def seed_of(seed: int) -> int:
    """Any whole number as a generator seed (torch takes 64 unsigned bits)."""
    return seed % (2 ** 63)


def draw(shapes: Dict[str, Shape], seed: int, device) -> Dict[str, torch.Tensor]:
    """One float32 tensor per leaf, views of one uniform draw made on
    ``device`` from ``seed``, each scaled to its :func:`bounds`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    lo = torch.empty(total, dtype=torch.float32)
    span = torch.empty(total, dtype=torch.float32)
    out, offsets, at = {}, {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        low, high = bounds(name, shapes)
        lo[at:at + n], span[at:at + n] = low, high - low
        offsets[name] = (at, n, shape)
        at += n
    flat = torch.addcmul(lo.to(device, non_blocking=True), flat, span.to(device, non_blocking=True))
    for name, (at, n, shape) in offsets.items():
        out[name] = flat[at:at + n].view(shape)
    return out
