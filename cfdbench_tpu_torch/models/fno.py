"""Fourier Neural Operator, the flagship autoregressive model (port of
``cfdbench_tpu/models/fno.py``).

Input channels are [u, v] ‖ mask ‖ (x, y) coordinates ‖ case-parameter
planes; a 1×1 lift to ``hidden_dim``; ``num_layers`` FnoBlocks
(spectral conv + 1×1 bypass + GELU); the head fc1(→128) → GELU →
fc2(→out_chan), multiplied by the mask.

On CUDA tensors every FnoBlock is one call of the fused block kernel and
the head one call of the fused head kernel (``ops/fno_kernels.py``) —
what the JAX package's ``fno2d_apply_pallas`` and
``fno2d_apply_pallas_head`` did with its two Pallas kernels, here on
every forward, in training too: the kernels' autograd Functions carry
the gradient. On CPU tensors both run their plain PyTorch versions.
The lift stays plain ``torch.matmul``.

In bfloat16 (``--use_mixed_precision``'s train forward, the bfloat16
rollout) the model runs the plain versions on either device, in the JAX
package's bfloat16 numerics: its Pallas kernels are float32 only and its
bfloat16 paths never reach them (``cfdbench_tpu/cli.py:580-593``). The
kernels take float32 only and raise on anything else.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import promote
from ..ops.fno_kernels import (
    fno_block,
    fno_block_reference,
    fno_head,
    fno_head_reference,
)
from ..ops.spectral import init_spectral_weights
from .common import Dense, coord_channels, ensure_mask

HEAD_WIDTH = 128
# The flagship configuration (ROADMAP.md, main path): depth 4, width 32,
# 12x12 modes.
FLAGSHIP = dict(num_layers=4, hidden_dim=32, modes1=12, modes2=12)


def lift(fc0: Dense, inputs, case_params, mask):
    """``fc0`` over [inputs ‖ mask ‖ coords ‖ params] as summed partial
    products on the weight's column slices: the concatenated input is
    never built, and the coordinate and case-parameter terms are
    broadcast, not full-field. Each product is taken in the common dtype
    of its operands, as in the JAX package (a float32 mask lifts a
    bfloat16 model to float32)."""
    _, H, W, C = inputs.shape
    k = fc0.weight  # (hidden, C + 3 + P)
    P = case_params.shape[-1]
    coords = coord_channels(1, H, W, dtype=inputs.dtype, device=inputs.device)

    def mm(a, w):
        a, w = promote(a, w)
        return a @ w.T

    return (
        mm(inputs, k[:, :C])
        + mm(mask, k[:, C:C + 1])
        + mm(coords, k[:, C + 1:C + 3])
        + mm(case_params, k[:, C + 3:C + 3 + P])[:, None, None, :]
        + fc0.bias
    )


class FnoBlock(nn.Module):
    """GELU(spectral conv + 1×1 bypass), one fused kernel on the card.

    ``weights`` are the spectral conv's (the JAX ``SpectralConv2d``'s),
    in the real-pair layout ``(corner, re/im, in, out, modes1, modes2)``.
    """

    def __init__(self, channels: int, modes1: int, modes2: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        self.weights = nn.Parameter(init_spectral_weights(
            generator, channels, channels, modes1, modes2
        ))
        self.w0 = Dense(channels, channels, generator=generator)

    def forward(self, x):
        return fno_block(x, self.weights, self.w0.weight, self.w0.bias,
                         self.modes1, self.modes2)


class Fno2d(nn.Module):
    """Autoregressive FNO: ``forward(inputs, case_params, mask) → preds``.

    inputs (B, H, W, in_chan); case_params (B, P); mask (B, H, W, 1),
    (B, H, W) or None. Returns (B, H, W, out_chan), masked. bfloat16
    inputs take :func:`fno2d_reference`, no kernel.
    Parameters are drawn from ``generator`` on the CPU, then moved to
    ``device``.
    """

    def __init__(self, in_chan: int = 2, out_chan: int = 2,
                 n_case_params: int = 5, num_layers: int = 4,
                 modes1: int = 12, modes2: int = 12, hidden_dim: int = 32,
                 padding: Optional[int] = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if padding is not None:
            raise NotImplementedError(
                "Fno2d padding is not ported (no CLI path sets it); "
                "see ROADMAP.md A8"
            )
        self.out_chan = out_chan
        self.fc0 = Dense(in_chan + 3 + n_case_params, hidden_dim,
                         generator=generator)
        self.blocks = nn.ModuleList(
            FnoBlock(hidden_dim, modes1, modes2, generator=generator)
            for _ in range(num_layers)
        )
        self.fc1 = Dense(hidden_dim, HEAD_WIDTH, generator=generator)
        self.fc2 = Dense(HEAD_WIDTH, out_chan, generator=generator)
        self.to(device)

    def forward(self, inputs, case_params, mask=None):
        if inputs.dtype == torch.bfloat16:
            return fno2d_reference(self, inputs, case_params, mask)
        B, H, W, _ = inputs.shape
        mask = ensure_mask(mask, B, H, W, device=inputs.device)
        x = lift(self.fc0, inputs, case_params, mask)
        for block in self.blocks:
            x = block(x)
        return fno_head(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                        self.fc2.bias, mask)


def fno2d_reference(model: Fno2d, inputs, case_params, mask=None):
    """``model``'s forward with both kernels replaced by their plain
    PyTorch versions, on whatever device the tensors are on: what the
    kernel path is held to on the card."""
    B, H, W, _ = inputs.shape
    mask = ensure_mask(mask, B, H, W, device=inputs.device)
    x = lift(model.fc0, inputs, case_params, mask)
    for blk in model.blocks:
        x = fno_block_reference(x, blk.weights, blk.w0.weight, blk.w0.bias,
                                blk.modes1, blk.modes2)
    return fno_head_reference(x, model.fc1.weight, model.fc1.bias,
                              model.fc2.weight, model.fc2.bias, mask)


class PlainFno2d(nn.Module):
    """``model`` behind :func:`fno2d_reference`: the same weights, both
    kernels replaced by their plain versions and differentiated by
    autograd; the yardstick of the kernel path in training."""

    def __init__(self, model: Fno2d):
        super().__init__()
        self.model, self.out_chan = model, model.out_chan

    def forward(self, inputs, case_params, mask=None):
        return fno2d_reference(self.model, inputs, case_params, mask)
