"""The non-autoregressive models, FFN and DeepONet (port of
``cfdbench_tpu/models/nonauto.py``; the reference's
``src/models/ffn.py:38-181`` and ``src/models/deeponet.py``).

Both map ``(case_params, t, query_xy)`` to u at the queried lattice
points: ``case_params`` (B, P), ``t`` (B, 1), ``query_xy`` (k, 2) raw
(row, col) lattice indices, not normalised (the reference comments its
normalisation out, ``deeponet.py:195``); the output is (B, k). Training
samples the queries (``training/trainer_nonauto.py``), evaluation asks
for the whole lattice.

With ``act_norm`` every activation is the scale-invariant
``norm_act``, which normalises over all of a sample's non-batch axes, so
the two models differ in what one sample is:

- ``FfnModel`` flattens to (B·k, P+3) rows before its MLP, as the
  reference does (``ffn.py:128-135``): each (sample, query) row is
  normalised over its features alone.
- ``DeepONet``'s trunk is (B, k, width): each sample is normalised over
  its queries and features together, so a prediction at one point
  depends on the other points of the same call (ROADMAP.md C). Callers
  must ask for the points the JAX package asks for in one call: the
  trainer's sampled points, or the whole lattice.

Submodules carry the reference's ``state_dict`` names: ``ffn``;
``branch_net``, ``fc_trunk_t``, ``fc_trunk_xy``, ``trunk_net``,
``bias``.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Dense, Mlp


class FfnModel(nn.Module):
    """MLP over [case_params ‖ x ‖ y ‖ t] → u at the query, with the
    scale-invariant ReLU between its layers (the only activation the JAX
    package builds it with, ``models/__init__.py:148-155``)."""

    pointwise = True
    out_chan = 1

    def __init__(self, n_case_params: int = 5, width: int = 100, depth: int = 8, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.ffn = Mlp([n_case_params + 3] + [width] * depth + [1], "relu", act_norm=True,
                       generator=generator)
        self.to(device)

    def forward(self, case_params, t, query_xy):
        B, P = case_params.shape
        k = query_xy.shape[0]
        inp = torch.cat([
            case_params[:, None, :].expand(B, k, P),
            query_xy[None].expand(B, k, 2),
            t[:, None, :].expand(B, k, 1),
        ], dim=-1)
        return self.ffn(inp.reshape(B * k, P + 3)).reshape(B, k)


class DeepONet(nn.Module):
    """Branch MLP on the case parameters; trunk ``fc_trunk_t(t) +
    fc_trunk_xy(x, y)`` → MLP; prediction Σ branch·trunk + bias
    (``deeponet.py:153-223``). ``act_on_output`` reaches the branch only."""

    pointwise = True
    out_chan = 1

    def __init__(self, n_case_params: int = 5, width: int = 100, branch_depth: int = 8,
                 trunk_depth: int = 8, act_name: str = "relu", act_norm: bool = False,
                 act_on_output: bool = False, *, generator: torch.Generator, device=None):
        super().__init__()
        self.branch_net = Mlp([n_case_params] + [width] * branch_depth, act_name, act_norm,
                              act_on_output, generator=generator)
        self.fc_trunk_t = Dense(1, width, generator=generator)
        self.fc_trunk_xy = Dense(2, width, generator=generator)
        self.trunk_net = Mlp([width] * trunk_depth, act_name, act_norm, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1))
        self.to(device)

    def forward(self, case_params, t, query_xy):
        branch = self.branch_net(case_params)  # (B, w)
        trunk = self.fc_trunk_t(t)[:, None, :] + self.fc_trunk_xy(query_xy)[None]  # (B, k, w)
        trunk = self.trunk_net(trunk)
        return torch.einsum("bp,bkp->bk", branch, trunk) + self.bias
