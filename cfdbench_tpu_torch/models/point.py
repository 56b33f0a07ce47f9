"""Point-query autoregressive models, the DeepONet family (port of
``cfdbench_tpu/models/point.py``; the reference's ``src/models/auto_ffn.py``,
``auto_deeponet.py``, ``auto_edeeponet.py``, ``auto_deeponet_cnn.py``).

All four flatten (parts of) the input field, score every point of the
full H x W query lattice in one batched pass, and add the input's u at
the query point as a residual. They model the u channel only: the
output is ``(B, H*W)``, and the trainer's loss is against the flattened u
labels, unmasked.

The query lattice is row-major (``product(range(H), range(W))``), so the
prediction at every query is a ``reshape(B, H*W)`` and the residual a
flatten. The trunk input is ``(xy - 50) / 100``.

``AutoFfn`` pairs every case with every query — the evident intent; the
reference tiles the case batch and the query list with different
periods (``auto_ffn.py:99-103``) and scrambles the pairing at batch > 1.
Its first layer is applied as a per-case term plus a per-query term on
the weight's column slices (``AutoFfn.forward``), so the
``(B, H*W, H*W + P + 2)`` input that the JAX package builds — 67 MB a
case at 64x64 — never exists.

The query lattice is float32, as the JAX package's is, so under bfloat16
(``--use_mixed_precision``, the bfloat16 rollout) the trunks, and the
AutoFfn's whole network, compute in float32 on bfloat16-rounded weights
and each model returns float32, as the JAX models do.

Under spatial sharding (``--shard_spatial 1``, ``sp`` the model axis over
which the grid rows split) a rank holds its rows of the field and scores
the queries of its rows: its lattice starts at its first global row, a
product over the whole flattened field (the AutoFfn's first layer on the
field, the DeepONet branches' first ``Dense``) is the sum over the model
ranks of each rank's rows against their columns of the weight
(:func:`field_dense`), and the CNN branch runs on the rank's rows, its
channel-major code gathered from every rank, differentiably
(``parallel/spatial.py::all_rows``). The loss's sums run over every rank
of the world, as a field model's do.

Submodules carry the reference's ``state_dict`` names (``ffn``,
``branch_net``, ``trunk_net``, ``branch1``, ``branch2``, ``bias``,
``branch_net.in_conv``/``blocks``/``out_conv``, ``out_ffn``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import promote
from ..parallel.spatial import Rows, active, all_rows, row_span, row_sum, to_pairs
from .common import (
    Conv,
    MaxPool2,
    Mlp,
    broadcast_params_to_channels,
    ensure_mask,
    get_act_fn,
)


def lattice_xy(H: int, W: int, *, device=None, r0: int = 0) -> torch.Tensor:
    """(H*W, 2) row-major (row, col) query coordinates, float32, of the
    ``H`` rows from global row ``r0`` on."""
    rows = torch.arange(r0, r0 + H, dtype=torch.float32, device=device).repeat_interleave(W)
    cols = torch.arange(W, dtype=torch.float32, device=device).repeat(H)
    return torch.stack([rows, cols], dim=-1)


def trunk_input(H: int, W: int, *, device=None, r0: int = 0) -> torch.Tensor:
    return (lattice_xy(H, W, device=device, r0=r0) - 50.0) / 100.0


def flat_u(inputs) -> torch.Tensor:
    """The u channel of (B, H, W, C) inputs as (B, H*W)."""
    return inputs[..., 0].reshape(inputs.shape[0], -1)


def field_product(w, flat, extra, axis) -> torch.Tensor:
    """[the whole flattened field ‖ ``extra``] @ the leading columns of
    ``w`` transposed, of which ``flat`` (B, h·W) is this rank's rows under
    spatial sharding over ``axis``: the rank's columns of ``w`` against its
    rows, summed over the model ranks, plus ``extra``'s (None: none)."""
    n = flat.shape[1]
    r0, N = row_span(n, axis)
    y = row_sum(flat @ w[:, r0:r0 + n].T, axis)
    return y if extra is None else y + extra @ w[:, N:N + extra.shape[1]].T


def field_dense(dense, flat, extra, axis) -> torch.Tensor:
    """``dense`` over [the whole flattened field ‖ ``extra``]
    (:func:`field_product`)."""
    if extra is None:
        flat, w, b = promote(flat, dense.weight, dense.bias)
    else:
        flat, extra, w, b = promote(flat, extra, dense.weight, dense.bias)
    return field_product(w, flat, extra, axis) + b


def mlp_on_field(mlp, flat, extra, axis):
    """``mlp`` (:class:`Mlp`) on [the flattened field ‖ ``extra``]: its first
    layer by :func:`field_dense`."""
    layers = mlp.layers
    return layers[1:](field_dense(layers[0], flat, extra, axis))


class AutoFfn(nn.Module):
    """MLP over [flat u ‖ case_params ‖ (x, y)] → u at the query, plus the
    input's u there (``auto_ffn.py:54-124``)."""

    pointwise = True
    out_chan = 1
    sp = None  # the model axis the grid rows split over

    def __init__(self, input_field_dim: int, num_case_params: int, width: int = 200,
                 depth: int = 8, act_name: str = "relu", *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.ffn = Mlp([input_field_dim + num_case_params + 2] + [width] * depth + [1],
                       act_name, generator=generator)
        self.to(device)

    def forward(self, inputs, case_params, mask=None):
        B, H, W = inputs.shape[:3]
        flat = flat_u(inputs)
        first, rest = self.ffn.layers[0], self.ffn.layers[1:]
        r0, grid = row_span(H, self.sp)
        n = grid * W + case_params.shape[1]
        if first.weight.shape[1] != n + 2:
            raise ValueError(f"AutoFfn was built for {first.weight.shape[1] - 2} field values "
                             f"and case parameters, got {n}")
        # The first Dense on [ctx ‖ xy], split on its weight's columns, in
        # the dtype that the concatenation would have: float32 at least.
        xy = lattice_xy(H, W, device=inputs.device, r0=r0)
        flat_, cp, xy, w, b = promote(flat, case_params, xy, first.weight, first.bias)
        ctx = field_product(w, flat_, cp, self.sp)  # (B, width)
        h = ctx[:, None, :] + (xy @ w[:, n:].T + b)[None]  # (B, HW, width)
        return rest(h)[..., 0] + flat


class AutoDeepONet(nn.Module):
    """Branch MLP over [flat u ‖ case_params]; trunk MLP over the
    normalised (x, y); dot-product head + bias + the input's u
    (``auto_deeponet.py:76-147``)."""

    pointwise = True
    out_chan = 1
    sp = None  # the model axis the grid rows split over

    def __init__(self, branch_dim: int, width: int = 100, branch_depth: int = 4,
                 trunk_depth: int = 4, act_name: str = "relu", *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.branch_net = Mlp([branch_dim] + [width] * branch_depth, act_name,
                              generator=generator)
        self.trunk_net = Mlp([2] + [width] * trunk_depth, act_name, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1))
        self.to(device)

    def forward(self, inputs, case_params, mask=None):
        H, W = inputs.shape[1:3]
        flat = flat_u(inputs)
        b = mlp_on_field(self.branch_net, flat, case_params, self.sp)  # (B, p)
        r0 = row_span(H, self.sp)[0]
        t = self.trunk_net(trunk_input(H, W, device=inputs.device, r0=r0))  # (HW, p)
        b, t = promote(b, t)
        return b @ t.T + self.bias + flat


class AutoEDeepONet(nn.Module):
    """Two branches (flat u; case params) fused by an elementwise product,
    a trunk dot-product head + bias + the input's u
    (``auto_edeeponet.py:66-125``)."""

    pointwise = True
    out_chan = 1
    sp = None  # the model axis the grid rows split over

    def __init__(self, dim_branch1: int, dim_branch2: int, width: int = 100,
                 branch_depth: int = 4, trunk_depth: int = 4, act_name: str = "relu", *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.branch1 = Mlp([dim_branch1] + [width] * branch_depth, act_name,
                           generator=generator)
        self.branch2 = Mlp([dim_branch2] + [width] * branch_depth, act_name,
                           generator=generator)
        self.trunk_net = Mlp([2] + [width] * trunk_depth, act_name, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1))
        self.to(device)

    def forward(self, inputs, case_params, mask=None):
        H, W = inputs.shape[1:3]
        flat = flat_u(inputs)
        fused = mlp_on_field(self.branch1, flat, None, self.sp) * self.branch2(case_params)
        r0 = row_span(H, self.sp)[0]
        t = self.trunk_net(trunk_input(H, W, device=inputs.device, r0=r0))
        fused, t = promote(fused, t)
        return fused @ t.T + self.bias + flat


class CnnBranch(nn.Module):
    """conv5x5, ``depth`` x [conv5x5 → maxpool2 → relu], conv5x5, zero
    padding, 32 channels throughout (``auto_deeponet_cnn.py:13-39``);
    ``blocks`` holds a conv at every third slot, as the reference's
    ``Sequential`` does. Under spatial sharding (``rows``, x's split) each
    pooling reads a split whose ranks hold whole row pairs
    (``parallel/spatial.py::Rows.pairs``; a deep one may leave a rank
    without a row, 16 rows over 2 ranks); :meth:`forward` returns the code's
    split with it."""

    def __init__(self, in_chan: int, depth: int = 4, *, generator: torch.Generator):
        super().__init__()
        self.in_conv = Conv(in_chan, 32, 5, padding=2, generator=generator)
        blocks = []
        for _ in range(depth):
            blocks += [Conv(32, 32, 5, padding=2, generator=generator), MaxPool2(),
                       get_act_fn("relu")]
        self.blocks = nn.Sequential(*blocks)
        self.out_conv = Conv(32, 32, 5, padding=2, generator=generator)

    def forward(self, x, rows: Rows = None):
        """``(code, its split)``; the split None without one."""
        x = self.in_conv(x, rows)
        blocks = self.blocks
        for i in range(0, len(blocks), 3):
            conv, pool, act = blocks[i:i + 3]
            x, rows = to_pairs(conv(x, rows), rows)
            x = act(pool(x, rows))
            rows = None if rows is None else rows.halved(ceil=False)
        return self.out_conv(x, rows), rows


def cnn_code_dim(field_shape: Tuple[int, int], depth: int = 4) -> int:
    """Length of the CNN branch's flattened code on an H x W field."""
    h, w = field_shape
    for _ in range(depth):
        h, w = h // 2, w // 2
    return 32 * h * w


# Why an AutoDeepONetCnn has no rollout: main_multistep and the serving
# export refuse it with this.
NO_ROLLOUT = (
    "auto_deeponet_cnn has no rollout: the point models feed back their 1-channel u "
    "frame (trainer_auto.AutoTask.feedback_channels), and AutoDeepONetCnn's first conv "
    "was built on the 2-channel input plus the mask and case-parameter planes; the JAX "
    "package's main_multistep fails on the same mismatch (ROADMAP.md C)")


class AutoDeepONetCnn(nn.Module):
    """CNN branch over [u, v ‖ mask ‖ case-parameter planes]; trunk MLP
    to the branch code's width; elementwise fusion, then an output MLP;
    plus the input's u (``auto_deeponet_cnn.py:42-184``). The branch
    code is flattened channel-major, (C, i, j), as the reference's
    ``view(b, -1)`` on NCHW: the code-trunk pairing depends on it. The
    code's width comes from ``field_shape``; the first conv takes
    ``in_chan + 1 + num_case_params`` channels, so a 1-channel frame
    (the point family's rollout feedback) does not fit it."""

    pointwise = True
    out_chan = 1
    sp = None  # the model axis the grid rows split over

    def __init__(self, in_chan: int = 2, num_case_params: int = 5,
                 field_shape: Tuple[int, int] = (64, 64), trunk_depth: int = 4,
                 act_name: str = "relu", *, generator: torch.Generator, device=None):
        super().__init__()
        D = cnn_code_dim(field_shape)
        self.in_chan = in_chan
        self.branch_net = CnnBranch(in_chan + 1 + num_case_params, generator=generator)
        self.trunk_net = Mlp([2] + [100] * trunk_depth + [D], act_name, generator=generator)
        self.out_ffn = Mlp([D, D, D, 1], act_name, generator=generator)
        self.to(device)

    def forward(self, inputs, case_params, mask=None):
        B, H, W = inputs.shape[:3]
        flat = flat_u(inputs)
        parts = [inputs]
        if mask is not None:
            parts.append(ensure_mask(mask, B, H, W))
        parts.append(broadcast_params_to_channels(case_params, H, W))
        x = torch.cat(parts, dim=-1)
        want = self.branch_net.in_conv.weight.shape[1]
        if x.shape[-1] != want:
            raise ValueError(f"AutoDeepONetCnn's first conv takes {want} channels, got "
                             f"{x.shape[-1]}")
        rows = Rows.of(H, self.sp) if active(self.sp) else None
        code, rows = self.branch_net(x, rows)
        code = all_rows(code, rows).permute(0, 3, 1, 2).reshape(B, -1)  # (B, D)
        r0 = row_span(H, self.sp)[0]
        t = self.trunk_net(trunk_input(H, W, device=inputs.device, r0=r0))  # (HW, D)
        return self.out_ffn(code[:, None, :] * t[None])[..., 0] + flat
