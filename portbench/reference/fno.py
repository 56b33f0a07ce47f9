"""The plain FNO of CFDBench (``src/models/fno/fno2d.py``), in float32
PyTorch: the yardstick of the rollout cells.

The interface that ``models.py`` finds by the configuration's ``model``:
``initial_stats``, ``predict``, ``forward_macs``. A
functional forward over a dict of the benchmark's weights, named as the
reference's ``state_dict`` (and the program's): ``fc0`` the lift, ``blocks.i``
with the spectral ``weights`` and the bypass ``w0``, ``fc1`` and ``fc2`` the
head. Channels last, ``(B, H, W, C)``.

Departures from ``fno2d.py``, each the program's too: the input is
[u, v | mask | x, y | case parameters], x the linspace over rows and y over
columns, all lifted by one 1x1 product; every block ends in GELU (the exact
erf), the last one included; the head's output is multiplied by the mask; the
spectral weights are kept as real pairs ``(corner, re/im, Cin, Cout, m1, m2)``;
the retained modes are clamped to half the grid's spectrum.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import counts

Weights = Dict[str, torch.Tensor]


def coordinates(B: int, H: int, W: int, device) -> torch.Tensor:
    x = torch.linspace(0.0, 1.0, H, device=device)
    y = torch.linspace(0.0, 1.0, W, device=device)
    grid = torch.stack(torch.meshgrid(x, y, indexing="ij"), dim=-1)
    return grid.expand(B, H, W, 2)


def lift(P: Weights, inputs, case_params, mask):
    B, H, W, _ = inputs.shape
    planes = case_params[:, None, None, :].expand(B, H, W, case_params.shape[-1])
    x = torch.cat([inputs, mask, coordinates(B, H, W, inputs.device), planes], dim=-1)
    return x @ P["fc0.weight"].T + P["fc0.bias"]


def spectral_conv(x, weights, m1: int, m2: int):
    """rfft2 over the grid, the two low-frequency row corners each mixed by
    its own complex weights, irfft2 back."""
    B, H, W, _ = x.shape
    m1, m2 = min(m1, H // 2), min(m2, W // 2 + 1)
    w = torch.complex(weights[:, 0, ..., :m1, :m2], weights[:, 1, ..., :m1, :m2])
    xf = torch.fft.rfft2(x, dim=(1, 2))
    out = xf.new_zeros((B, H, W // 2 + 1, weights.shape[3]))
    out[:, :m1, :m2] = torch.einsum("bxyi,ioxy->bxyo", xf[:, :m1, :m2], w[0])
    out[:, H - m1:, :m2] = torch.einsum("bxyi,ioxy->bxyo", xf[:, H - m1:, :m2], w[1])
    return torch.fft.irfft2(out, s=(H, W), dim=(1, 2))


def forward(P: Weights, inputs, case_params, mask, depth: int, m1: int, m2: int):
    """The next frame ``(B, H, W, out)`` of ``inputs``, masked."""
    x = lift(P, inputs, case_params, mask)
    for i in range(depth):
        b = f"blocks.{i}."
        x = F.gelu(spectral_conv(x, P[b + "weights"], m1, m2)
                   + x @ P[b + "w0.weight"].T + P[b + "w0.bias"])
    h = F.gelu(x @ P["fc1.weight"].T + P["fc1.bias"])
    return (h @ P["fc2.weight"].T + P["fc2.bias"]) * mask


def initial_stats(config: dict, P: Weights) -> Weights:
    """No running statistics: the FNO has no norms."""
    return {}


def predict(config: dict, P: Weights, S: Weights, inputs, case_params, mask):
    a = config["args"]
    return forward(P, inputs, case_params, mask, a["fno_depth"], a["fno_modes_x"],
                   a["fno_modes_y"])


def forward_macs(config: dict, batch: int) -> int:
    """Multiply-adds of one forward of ``batch`` cases (``counts.py``)."""
    a, (H, W) = config["args"], config["grid"]
    return counts.fno_step_macs(batch, H, W, a["in_chan"], config["n_case_params"],
                                a["fno_hidden_dim"], a["fno_depth"], a["fno_modes_x"],
                                a["fno_modes_y"], config["head_width"], a["out_chan"])
