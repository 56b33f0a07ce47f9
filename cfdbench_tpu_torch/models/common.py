"""Shared model pieces (port of ``cfdbench_tpu/models/common.py``). NHWC
tensors; ``nn.Linear`` and ``nn.Conv2d`` weight layouts, so that a
reference CFDBench ``state_dict`` loads by name.

Under ``--use_mixed_precision`` and a bfloat16 rollout the modules run
in the JAX package's bfloat16 numerics: a layer computes in the common
dtype of its input and its weights (:func:`promote`, flax's
``promote_dtype``), so a bfloat16 input meets bfloat16 weights in
bfloat16 and a float32 input (the point models' lattice, the PUNetG's
timestep embedding) lifts the layer to float32; a norm reduces and
normalises in float32 and returns that common dtype (flax's
``force_float32_reductions``).

Under spatial sharding (``--shard_spatial 1``; ``sp``, the model axis
over which the grid rows split, set by ``trainer_auto.split_model``) a
:class:`Conv` takes its rows above and below from the ranks that hold them
(``parallel/spatial.py::halo``), at stride 1 or 2, on the even split or on
the split (``Rows``) that its caller passes; :class:`MaxPool2` pools a
rank's whole row pairs; :class:`GroupNorm` sums each sample's statistics
over the model ranks; and :func:`coord_channels` gives a rank's rows of the
global coordinates. A level of a model that halves the grid may leave a
rank without a row: there each of these returns the rank's empty output
and still takes part in the level's exchanges and sums, and its
parameters' gradients are zeros (:func:`conv_rows`).

Not ported: ``dense_thin``, a TPU workaround for the backward of the
FNO head's fc2; ``gelu_exact``, whose rational erf was a TPU workaround
for a missing erf lowering — the port uses ``F.gelu``, whose default is
the true-erf GELU (the two differ by at most 1.5e-7).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import common_dtype, promote
from ..parallel.spatial import Rows, active, halo, row_span, row_sum, rows_of


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

    OUT_AXIS = 0  # the weight's output features (parallel/sharding_rules.py)

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator):
        super().__init__()
        w = torch.empty((out_features, in_features), dtype=torch.float32)
        b = torch.empty((out_features,), dtype=torch.float32)
        self.weight = nn.Parameter(torch_kernel_init(w, generator))
        self.bias = nn.Parameter(torch_bias_init(b, in_features, generator))

    def forward(self, x):
        return F.linear(*promote(x, self.weight, self.bias))


def conv_rows(x, w, b, stride: int = 1, padding=0, empty: bool = False):
    """``F.conv2d`` of the NCHW ``x``; with ``empty`` (a rank that holds no
    row of its level under spatial sharding: ``x`` is its halo alone, or
    nothing, shorter than the kernel) ``x`` zero-padded at the bottom to the
    kernel's height and none of the output kept, so that the convolution
    stays in the graph and its backward hands ``x`` (the halo's exchange)
    and the weights zeros, as every rank's backward must enter the same
    sums."""
    if not empty:
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    x = F.pad(x, (0, 0, 0, max(0, w.shape[2] - x.shape[2])))
    return F.conv2d(x, w, b, stride=stride, padding=padding)[:, :, :0]


class Conv(nn.Module):
    """NHWC 2-D convolution with torch-default init drawn from
    ``generator``; ``weight`` is ``(out, in, k, k)``. With
    ``replicate_pad`` the border is padded by edge replication (the
    reference's ``padding_mode="replicate"``), else with zeros. Under
    spatial sharding (``sp``) x is a rank's rows, of the even split or of
    ``rows`` (``parallel/spatial.py::Rows``): a convolution with 2
    ``padding`` = k - 1 takes ``padding`` rows from the ranks above and
    below, the grid's own border padded as without it; at stride 2 it
    takes the rows of a split whose ranks hold whole row pairs
    (:meth:`Rows.paired`), and its output rows are that split halved
    (rounded up)."""

    OUT_AXIS = 0
    sp = None  # the model axis the grid rows split over (trainer_auto.split_model)

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

    def forward(self, x, rows: Optional[Rows] = None):
        p = self.padding
        if active(self.sp) and self.weight.shape[-1] > 1:
            return self._rows_forward(x, rows_of(x, self.sp, rows))
        x, w, b = promote(x.permute(0, 3, 1, 2), self.weight, self.bias)  # an NCHW view
        if self.replicate_pad and p:
            x = F.pad(x, (p, p, p, p), mode="replicate")
            p = 0
        # No row: a 1x1 convolution on a rank that holds none of its level.
        return conv_rows(x, w, b, self.stride, p, empty=not x.shape[2]).permute(0, 2, 3, 1)

    def _rows_forward(self, x, rows: Rows):
        p, k, s = self.padding, self.weight.shape[-1], self.stride
        if s not in (1, 2) or 2 * p != k - 1:
            raise ValueError(f"--shard_spatial 1: a {k}x{k} convolution at stride {s}, "
                             f"padding {p} on a rank's rows: the port splits those whose 2 "
                             "padding is k - 1 (ROADMAP.md C; the VAE's stride-2 one of padding "
                             "0 is models/vae.py::downsample)")
        if s == 2 and not rows.paired():
            raise ValueError(f"--shard_spatial 1: a stride-2 convolution on the rows {rows}, "
                             "whose ranks do not hold whole row pairs (Rows.pairs)")
        x = halo(x, p, self.sp, self.replicate_pad, rows=rows)
        x, w, b = promote(x.permute(0, 3, 1, 2), self.weight, self.bias)
        if self.replicate_pad:
            x, p = F.pad(x, (p, p, 0, 0), mode="replicate"), 0
        return conv_rows(x, w, b, s, (0, p), empty=not rows.h).permute(0, 2, 3, 1)


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
    (``tests/test_torch_diffusion.py``). It normalises in float32 at
    least and returns the common dtype of x and its weights (flax's).
    Under spatial sharding (``sp``) x is a rank's rows: each rank takes its
    rows' group means and squared deviations from them (two passes, as
    torch's), and one sum over the model ranks, in float64, combines them
    (Chan et al.'s parallel variance: Σ n_i μ_i and Σ (M2_i + n_i μ_i²),
    whose difference's cancellation, at the scale of the ranks' means,
    float64 absorbs)."""

    sp = None  # the model axis the grid rows split over

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        out = common_dtype(x, self.weight, self.bias)
        work = torch.promote_types(out, torch.float32)
        if active(self.sp):
            return self._rows_forward(x.to(work), work).to(out)
        x = x.permute(0, 3, 1, 2).to(work)
        if x.device.type == "cpu" and not x.requires_grad:
            # torch's CPU backward of a channels-last group norm whose input
            # needs no gradient (its weights do) crashes; a contiguous one
            # does not.
            x = x.contiguous()
        # The ATen op, not F.group_norm, whose check refuses a group of one
        # value in training (a 1x1 field at one channel a group), which flax
        # normalises to its bias.
        return torch.group_norm(x, self.num_groups, self.weight.to(work), self.bias.to(work),
                                self.eps).permute(0, 2, 3, 1).to(out)

    def _rows_forward(self, x, work):
        B, h, W, C = x.shape
        G = self.num_groups
        xg = x.reshape(B, h, W, G, C // G)
        dims, n = (1, 2, 4), h * W * (C // G)
        # A rank without rows adds zero sums and a zero count.
        mean = xg.mean(dims) if n else xg.sum(dims)
        m2 = (xg - mean[:, None, None, :, None]).square().sum(dims)
        wide = mean.to(torch.float64)
        count, s1, s2 = row_sum(torch.stack([torch.full_like(wide, n), n * wide,
                                             m2.to(torch.float64) + n * wide.square()]),
                                self.sp)
        mu = s1 / count
        var = (s2 / count - mu.square()).to(work)
        d = xg - mu.to(work)[:, None, None, :, None]
        y = (d * torch.rsqrt(var + self.eps)[:, None, None, :, None]).reshape(B, h, W, C)
        return y * self.weight.to(work) + self.bias.to(work)


class MaxPool2(nn.Module):
    """2x2 max pool, stride 2, over the H and W of an NHWC tensor; odd
    edges are dropped (flax's and torch's VALID pooling). Under spatial
    sharding (``sp``) it pools a rank's rows of the even split or of
    ``rows``, whose ranks must hold whole row pairs (:meth:`Rows.paired`;
    a window would otherwise cross ranks): its output rows are that split
    halved, none on a rank that holds none."""

    sp = None

    def forward(self, x, rows: Optional[Rows] = None):
        if active(self.sp) and not rows_of(x, self.sp, rows).paired():
            raise ValueError(f"--shard_spatial 1: MaxPool2 on a rank's {x.shape[1]} rows, an odd "
                             "count: a pooling window would cross ranks (Rows.pairs)")
        if not x.shape[1]:
            return x[:, :, :x.shape[2] // 2]
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


def cast_call(module: nn.Module, dtype, *args, **kwargs):
    """``module(*args, **kwargs)`` on copies of its parameters cast to
    ``dtype``, its buffers as they are (a BatchNorm's running statistics
    stay float32): the JAX package's mixed-precision forward
    (``trainer_auto.AutoTask._cast``). Autograd through the casts brings
    the gradients back to the float32 parameters. ``dtype`` None calls
    the module itself."""
    if dtype is None:
        return module(*args, **kwargs)
    params = {name: p.to(dtype) for name, p in module.named_parameters()}
    return torch.func.functional_call(module, params, args, kwargs)


def broadcast_params_to_channels(case_params, h: int, w: int):
    """(B, P) → (B, H, W, P) constant channel planes (a broadcast view)."""
    return case_params[:, None, None, :].expand(case_params.shape[0], h, w,
                                                case_params.shape[1])


def coord_channels(batch: int, h: int, w: int, *, dtype=torch.float32,
                   device=None, rows=None):
    """(B, H, W, 2): x = linspace over rows, y = linspace over columns,
    computed in float32 at least and rounded to ``dtype`` (JAX's bfloat16
    linspace). With ``rows`` (spatial sharding) the ``h`` rows are a
    rank's of the global grid, and x its rows of the global linspace."""
    work = torch.promote_types(dtype, torch.float32)
    r0, H = row_span(h, rows)
    gx = torch.linspace(0.0, 1.0, H, dtype=work, device=device)[r0:r0 + h].to(dtype)
    gy = torch.linspace(0.0, 1.0, w, dtype=work, device=device).to(dtype)
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
