"""Spatial sharding (sp): the grid rows of every field split over a mesh's
model axis (counterpart of ``cfdbench_tpu/parallel/mesh.py::
batch_sharding_spatial``).

The JAX package places each (B, H, W, C) field as ``P(data, model)`` and
lets XLA's partitioner insert the exchanges, so its models run unchanged.
The port makes them explicit. Model rank j of M holds the rows
``[j h, (j + 1) h)`` of a grid of ``H = M h`` rows (:func:`row_span`), the
split that the batches arrive in. A model whose poolings or stride-2
convolutions halve the grid tracks, level by level, which rows each rank
holds (:class:`Rows`: spans that may be uneven, or empty where a level
has fewer row pairs than there are ranks) and moves rows between two such
splits (:func:`reshard`), so that a rank holds whole pooling windows and
whole stride-2 pairs (:meth:`Rows.pairs`). A rank without a row at a level
takes part in that level's exchanges all the same, with empty slots
(``models/common.py`` convolves nothing there). The exchanges are
differentiable, over the model group (``axis``: a ``mesh.ModelAxis``, or a
:class:`Rows` over one):

- :func:`halo`: a convolution's ``k`` rows above and below the rank's
  rows, from however many ranks hold them; at the grid's true top and
  bottom zeros or, with ``replicate``, the edge row repeated. The backward
  sends the halo rows' gradients back to the ranks that own those rows.
- :func:`reshard`: a rank's rows of one split → its rows of another; the
  backward routes the gradients back alike.
- :func:`all_rows`: every rank's rows, on every rank (the point models'
  branch codes); the backward hands each rank the gradient of its own
  rows, summed over the ranks that used them.
- :func:`row_sum`: a sum over the model ranks whose backward sums the
  gradients too (``ModelAxis.sum``, ``mesh.py::_SumOverRanks``): each rank
  uses the sum for its own rows (the FNO's retained spectrum, a row-axis
  DFT's modes, a GroupNorm's statistics, a product over the flattened
  field).
- :func:`gather_rows`: every rank's rows, concatenated, without a
  gradient (the predictions and the plots).

Every exchange is an all-reduce of zero-padded slots, as in
``tensor.py``: gloo carries CUDA tensors that way. The first three share
one form (:func:`_fetch`): the rows that some rank needs from another,
each placed by its owner in a slot of a buffer that every rank builds
alike, summed over the ranks, and read. Within a model, every rank makes
the same exchanges in the same order. Since every sum over ranks (the
loss's, the norms', these) passes its gradients on to every rank, a
rank's gradient of a parameter is the partial of its rows times the N·M
ranks that seed the backward: the trainer takes the mean over the ranks
(``training/trainer_auto.py::reduce_gradients``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def model_axis(axis):
    """The model axis of ``axis``: itself, or the axis of a :class:`Rows`."""
    return axis.axis if isinstance(axis, Rows) else axis


def active(axis) -> bool:
    """Whether ``axis`` splits rows: a model axis of more than one rank, or
    a :class:`Rows` over one."""
    axis = model_axis(axis)
    return axis is not None and axis.distributed


def row_span(h: int, axis):
    """``(r0, H)``: the first global row of a rank that holds ``h`` rows of
    the even split over ``axis``, or of ``axis`` itself where it is a
    :class:`Rows`, and the grid's height (``(0, h)`` without a split)."""
    if isinstance(axis, Rows):
        return axis.r0, axis.H
    if not active(axis):
        return 0, h
    rows = Rows.of(h, axis)
    return rows.r0, rows.H


class Rows:
    """A split of an ``H``-row grid over a model axis: rank j holds the rows
    ``[bounds[j], bounds[j + 1])``, ``bounds[0] = 0`` and ``bounds[-1] = H``;
    a rank may hold none (equal bounds). Every rank builds the same splits,
    so each knows every rank's rows."""

    def __init__(self, axis, bounds: Sequence[int]):
        self.axis, self.bounds = axis, tuple(int(b) for b in bounds)
        if any(b1 < b0 for b0, b1 in zip(self.bounds, self.bounds[1:])):
            raise ValueError(f"the rows {self.bounds} of a split over {self.axis.size} ranks "
                             "fall")

    @classmethod
    def even(cls, H: int, axis) -> "Rows":
        """The split the batches arrive in: ``H / M`` rows a rank."""
        return cls(axis, [j * H // axis.size for j in range(axis.size + 1)])

    @classmethod
    def of(cls, h: int, axis) -> "Rows":
        """The even split of a grid of which this rank holds ``h`` rows."""
        return cls.even(h * axis.size, axis)

    @property
    def H(self) -> int:
        return self.bounds[-1]

    @property
    def r0(self) -> int:
        return self.bounds[self.axis.rank]

    @property
    def h(self) -> int:
        return self.bounds[self.axis.rank + 1] - self.r0

    def __eq__(self, other) -> bool:
        return isinstance(other, Rows) and self.bounds == other.bounds

    def __repr__(self) -> str:
        return f"Rows{self.bounds}"

    def paired(self) -> bool:
        """Whether every rank but the last holds whole row pairs of the grid
        (its rows start on an even row and end on one)."""
        return all(b % 2 == 0 for b in self.bounds[:-1])

    def pairs(self) -> "Rows":
        """The nearest split in which every rank but the last holds whole row
        pairs: each inner bound rounded down to an even row (up where that
        would leave a rank empty, unless that passes the grid's bottom: there
        the rank goes empty)."""
        bounds = list(self.bounds)
        for j in range(1, len(bounds) - 1):
            b = bounds[j] - bounds[j] % 2
            bounds[j] = b if b > bounds[j - 1] or b + 2 > self.H else b + 2
        return Rows(self.axis, bounds)

    def resized(self, H: int) -> "Rows":
        """This split with the last rank's rows padded or cropped at the
        grid's bottom to ``H`` rows: a field zero-padded at the bottom
        (``models/fno.py::pad``, ``models/diffusion.py::pad_field``) or
        cropped back."""
        return Rows(self.axis, self.bounds[:-1] + (H,))

    def halved(self, ceil: bool) -> "Rows":
        """The split of a 2x pool (``ceil`` False: an odd last row dropped)
        or a stride-2 convolution (``ceil`` True) of a :meth:`paired` split."""
        last = -(-self.H // 2) if ceil else self.H // 2
        return Rows(self.axis, [b // 2 for b in self.bounds[:-1]] + [last])

    def doubled(self, H: int) -> "Rows":
        """The split of a 2x upsampling of this one, cropped or padded at the
        bottom to ``H`` rows."""
        return Rows(self.axis, [2 * b for b in self.bounds[:-1]] + [H])

    def halvings(self, n: int, ceil: bool) -> List["Rows"]:
        """This split and those of ``n`` halvings after it, each of a split
        resharded to :meth:`pairs` (a model's levels; a deep one may leave a
        rank without a row)."""
        levels = [self]
        for _ in range(n):
            levels.append(levels[-1].pairs().halved(ceil))
        return levels


def to_pairs(x: torch.Tensor, rows: Optional[Rows]):
    """``(x, split)``: x resharded to the nearest split whose ranks hold whole
    row pairs (:meth:`Rows.pairs`), ahead of a pool or a stride-2 conv;
    ``(x, None)`` without a split."""
    if rows is None:
        return x, None
    return reshard(x, rows, rows.pairs()), rows.pairs()


def rows_of(x: torch.Tensor, axis, rows: Optional[Rows] = None, dim: int = 1) -> Rows:
    """``rows``, or ``axis`` where it is a :class:`Rows`, or the even split of
    which ``x`` holds this rank's rows (a level that may leave a rank
    without a row passes its split: an empty rank cannot infer it)."""
    if rows is not None:
        return rows
    return axis if isinstance(axis, Rows) else Rows.of(x.shape[dim], axis)


def take_rows(x: torch.Tensor, axis, dim: int = 1) -> torch.Tensor:
    """This rank's rows of a whole field (along ``dim``): of the even split
    over ``axis``, or of ``axis`` itself where it is a :class:`Rows`."""
    if isinstance(axis, Rows):
        return x.narrow(dim, axis.r0, axis.h)
    if not active(axis):
        return x
    rows = Rows.even(x.shape[dim], axis)
    return x.narrow(dim, rows.r0, rows.h)


_PLANS = {}


def _plan(bounds: Tuple[int, ...], wants: Tuple[Tuple[int, int], ...], rank: int):
    """How :func:`_fetch` moves rows: ``(slots, sends, parts)``. ``slots``
    counts the global rows that some rank wants and another holds (in
    ascending order); ``sends`` lists this rank's runs of them as ``(slot,
    local row, n)``; ``parts`` this rank's wanted rows as runs ``(from_x,
    start, n)``, each from its own rows or from the slots. Kept by its
    arguments: a model makes the same exchanges every step."""
    key = (bounds, wants, rank)
    if key not in _PLANS:
        _PLANS[key] = _make_plan(bounds, wants, rank)
    return _PLANS[key]


def _make_plan(bounds, wants, rank):
    owner = [j for j in range(len(bounds) - 1) for _ in range(bounds[j], bounds[j + 1])]
    moved = sorted({r for j, (lo, hi) in enumerate(wants) for r in range(lo, hi)
                    if owner[r] != j})
    slot = {r: i for i, r in enumerate(moved)}
    r0 = bounds[rank]

    def runs(items):
        out = []
        for a, b in items:  # consecutive in both a and b extend a run
            if out and out[-1][0] + out[-1][2] == a and out[-1][1] + out[-1][2] == b:
                out[-1] = (out[-1][0], out[-1][1], out[-1][2] + 1)
            else:
                out.append((a, b, 1))
        return out

    sends = runs([(slot[r], r - r0) for r in moved if owner[r] == rank])
    lo, hi = wants[rank]
    parts = []
    for r in range(lo, hi):
        src = (owner[r] == rank, r - r0 if owner[r] == rank else slot[r])
        if parts and parts[-1][0] == src[0] and parts[-1][1] + parts[-1][2] == src[1]:
            parts[-1] = (src[0], parts[-1][1], parts[-1][2] + 1)
        else:
            parts.append((src[0], src[1], 1))
    return len(moved), sends, parts


def _fetch(x: torch.Tensor, rows: Rows, wants: List[Tuple[int, int]], dim: int) -> torch.Tensor:
    """This rank's global rows ``[lo, hi) = wants[rank]`` of the field whose
    rows ``x`` holds under ``rows``; every rank passes every rank's
    ``wants``. The rows held elsewhere come through one all-reduce of a
    buffer of slots, each filled by its row's owner (:func:`_plan`);
    autograd carries the gradients back through it to the owners."""
    n, sends, parts = _plan(rows.bounds, tuple(wants), rows.axis.rank)
    buf = None
    if n:
        # x.narrow(dim, 0, 0): the buffer needs x's gradient on every rank,
        # one that sends no row too, so that its backward runs everywhere.
        pieces, at = [x.narrow(dim, 0, 0)], 0
        for s, l, k in sends:
            if s > at:
                pieces.append(x.new_zeros(_with(x.shape, dim, s - at)))
            pieces.append(x.narrow(dim, l, k))
            at = s + k
        if n > at:
            pieces.append(x.new_zeros(_with(x.shape, dim, n - at)))
        buf = rows.axis.sum(torch.cat(pieces, dim).contiguous())
    # A rank that wants no row gets none of x (an empty output all the same).
    out = [(x if from_x else buf).narrow(dim, s, k) for from_x, s, k in parts] or [
        x.narrow(dim, 0, 0)]
    if buf is not None and all(from_x for from_x, _, _ in parts):
        # No row of the buffer here, but its backward (the all-reduce of its
        # gradient) runs on every rank, so the output reads none of it.
        out.append(buf.narrow(dim, 0, 0))
    return out[0] if len(out) == 1 else torch.cat(out, dim)


def _with(shape, dim: int, n: int):
    shape = list(shape)
    shape[dim] = n
    return shape


def halo(x: torch.Tensor, k: int, axis, replicate: bool = False, dim: int = 1,
         rows: Optional[Rows] = None, above: Optional[int] = None) -> torch.Tensor:
    """x with ``k`` rows more on each side along ``dim`` (``above`` rows on
    top where given, as 0 for a stride-2 convolution padded at the bottom
    alone): the rows that the ranks above and below hold (however many
    ranks that takes, under the even split or ``rows``), and beyond the
    grid's top and bottom zeros or, with ``replicate``, copies of the edge
    row (``F.pad``'s ``replicate``)."""
    above = k if above is None else above
    if not (k or above) or not active(axis):
        return x
    rows = rows_of(x, axis, rows, dim)
    b, H, M = rows.bounds, rows.H, rows.axis.size
    wants = [(max(0, b[j] - above), min(H, b[j + 1] + k)) for j in range(M)]
    y = _fetch(x, rows, wants, dim)
    lo, hi = wants[rows.axis.rank]
    top, bottom = above - (rows.r0 - lo), k - (hi - rows.r0 - rows.h)
    if not top and not bottom:
        return y
    parts = [y]
    if top:
        edge = y.narrow(dim, 0, 1) if replicate else y.new_zeros(_with(y.shape, dim, 1))
        parts.insert(0, edge.expand(_with(y.shape, dim, top)))
    if bottom:
        edge = (y.narrow(dim, y.shape[dim] - 1, 1) if replicate
                else y.new_zeros(_with(y.shape, dim, 1)))
        parts.append(edge.expand(_with(y.shape, dim, bottom)))
    return torch.cat(parts, dim)


def reshard(x: torch.Tensor, src: Optional[Rows], dst: Optional[Rows],
            dim: int = 1) -> torch.Tensor:
    """This rank's rows of ``dst`` from its rows ``x`` of ``src`` (the same
    grid); ``x`` itself where the splits agree or there is none."""
    if src is None or src == dst:
        return x
    if src.H != dst.H:
        raise ValueError(f"reshard between grids of {src.H} and {dst.H} rows")
    b = dst.bounds
    return _fetch(x, src, [(b[j], b[j + 1]) for j in range(len(b) - 1)], dim)


def all_rows(x: torch.Tensor, rows: Optional[Rows], dim: int = 1) -> torch.Tensor:
    """Every rank's rows of ``x`` (split as ``rows``), in order, on every
    rank, differentiably: the backward sums over the ranks the gradients
    of each rank's rows and hands them to it. ``x`` itself without a
    split."""
    if rows is None or not active(rows.axis):
        return x
    return _fetch(x, rows, [(0, rows.H)] * rows.axis.size, dim)


def row_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` (real or complex) summed over the model ranks, differentiably:
    the backward sums the gradients over them too."""
    if not active(axis):
        return x
    if x.is_complex():
        return torch.view_as_complex(row_sum(torch.view_as_real(x), axis))
    return model_axis(axis).sum(x.contiguous())


def row_sum_(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` (real, or complex) summed over the model ranks in place, outside
    autograd (a kernel's scratch, a gradient in a backward)."""
    if active(axis):
        dist.all_reduce(torch.view_as_real(x) if x.is_complex() else x,
                        group=model_axis(axis).group)
    return x


def gather_rows(x: torch.Tensor, axis, dim: int = 1) -> torch.Tensor:
    """Every model rank's rows of ``x`` (the even split), in rank order, on
    every rank, without a gradient: :func:`all_rows` outside autograd."""
    if not active(axis):
        return x
    with torch.no_grad():
        return all_rows(x, Rows.of(x.shape[dim], axis), dim)
