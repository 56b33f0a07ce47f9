"""Spatial sharding (sp): the grid rows of every field split over a mesh's
model axis (counterpart of ``cfdbench_tpu/parallel/mesh.py::
batch_sharding_spatial``).

The JAX package places each (B, H, W, C) field as ``P(data, model)`` and
lets XLA's partitioner insert the exchanges, so its models run unchanged.
The port makes them explicit. Model rank j of M holds the rows
``[j h, (j + 1) h)`` of a grid of ``H = M h`` rows (:func:`row_span`), and
its models exchange through three autograd Functions over the model
group (``axis``: a ``mesh.ModelAxis``):

- :func:`halo`: a convolution's ``k`` rows above and below the rank's
  rows, from the neighbouring ranks; at the grid's true top and bottom
  zeros or, with ``replicate``, the edge row repeated. The backward sends
  the halo rows' gradients back to the ranks that own those rows.
- :func:`row_sum`: a sum over the model ranks whose backward sums the
  gradients too (``ModelAxis.sum``, ``mesh.py::_SumOverRanks``): each rank
  uses the sum for its own rows (the FNO's retained spectrum, a row-axis
  DFT's modes).
- :func:`gather_rows`: every rank's rows, concatenated, without a
  gradient (the predictions and the plots).

Every exchange is an all-reduce of zero-padded slots, as in
``tensor.py``: gloo carries CUDA tensors that way. Within a model, every
rank makes the same exchanges in the same order. Since every sum over
ranks (the loss's, the norms', these) passes its gradients on to every
rank, a rank's gradient of a parameter is the partial of its rows times
the N·M ranks that seed the backward: the trainer takes the mean over
the ranks (``training/trainer_auto.py::reduce_gradients``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def active(axis) -> bool:
    """Whether ``axis`` splits rows: a model axis of more than one rank."""
    return axis is not None and axis.distributed


def row_span(h: int, axis):
    """``(r0, H)``: the first global row of a rank that holds ``h`` rows,
    and the grid's height (``(0, h)`` without a split)."""
    if not active(axis):
        return 0, h
    return axis.rank * h, h * axis.size


def take_rows(x: torch.Tensor, axis, dim: int = 1) -> torch.Tensor:
    """This rank's rows of a whole field (along ``dim``)."""
    if not active(axis):
        return x
    h = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * h, h)


class _Halo(torch.autograd.Function):
    """``(above, below)``: the ``k`` rows along ``dim`` that the ranks above
    and below hold next to this rank's rows, zeros where there is none."""

    @staticmethod
    def forward(ctx, x, k, axis, dim):
        ctx.k, ctx.axis, ctx.dim = k, axis, dim
        M, j, h = axis.size, axis.rank, x.shape[dim]
        edge = x.narrow(dim, 0, k)
        slots = x.new_zeros((M, 2) + tuple(edge.shape))
        slots[j, 0] = edge
        slots[j, 1] = x.narrow(dim, h - k, k)
        dist.all_reduce(slots, group=axis.group)
        above = slots[j - 1, 1] if j > 0 else slots.new_zeros(edge.shape)
        below = slots[j + 1, 0] if j < M - 1 else slots.new_zeros(edge.shape)
        ctx.h = h
        return above.contiguous(), below.contiguous()

    @staticmethod
    def backward(ctx, g_above, g_below):
        k, axis, dim = ctx.k, ctx.axis, ctx.dim
        M, j = axis.size, axis.rank
        slots = g_above.new_zeros((M, 2) + tuple(g_above.shape))
        if j > 0:
            slots[j - 1, 1] = g_above  # rows that rank j - 1 holds at its bottom
        if j < M - 1:
            slots[j + 1, 0] = g_below  # rows that rank j + 1 holds at its top
        dist.all_reduce(slots, group=axis.group)
        shape = list(g_above.shape)
        shape[dim] = ctx.h
        dx = g_above.new_zeros(shape)
        dx.narrow(dim, 0, k).add_(slots[j, 0])
        dx.narrow(dim, ctx.h - k, k).add_(slots[j, 1])
        return dx, None, None, None


def halo(x: torch.Tensor, k: int, axis, replicate: bool = False, dim: int = 1) -> torch.Tensor:
    """x with ``k`` rows more on each side along ``dim``: the neighbouring
    ranks' rows, and at the grid's top and bottom zeros or, with
    ``replicate``, copies of the edge row (``F.pad``'s ``replicate``). A
    rank must hold at least ``k`` rows."""
    if k == 0 or not active(axis):
        return x
    h = x.shape[dim]
    if h < k:
        raise ValueError(f"--shard_spatial 1: a rank's {h} rows are fewer than the {k} rows "
                         "of a convolution's halo; use fewer model ranks or a taller grid")
    above, below = _Halo.apply(x, k, axis, dim)
    if replicate and axis.rank == 0:
        above = x.narrow(dim, 0, 1).expand_as(above)
    if replicate and axis.rank == axis.size - 1:
        below = x.narrow(dim, h - 1, 1).expand_as(below)
    return torch.cat([above, x, below], dim)


def row_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` (real or complex) summed over the model ranks, differentiably:
    the backward sums the gradients over them too."""
    if not active(axis):
        return x
    if x.is_complex():
        return torch.view_as_complex(row_sum(torch.view_as_real(x), axis))
    return axis.sum(x.contiguous())


def row_sum_(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` (real, or complex) summed over the model ranks in place, outside
    autograd (a kernel's scratch, a gradient in a backward)."""
    if active(axis):
        dist.all_reduce(torch.view_as_real(x) if x.is_complex() else x, group=axis.group)
    return x


def gather_rows(x: torch.Tensor, axis, dim: int = 1) -> torch.Tensor:
    """Every model rank's rows of ``x``, in rank order, on every rank,
    without a gradient."""
    if not active(axis):
        return x
    shape = list(x.shape)
    shape[dim] *= axis.size
    out = x.new_zeros(shape)
    out.narrow(dim, axis.rank * x.shape[dim], x.shape[dim]).copy_(x.detach())
    dist.all_reduce(out, group=axis.group)
    return out
