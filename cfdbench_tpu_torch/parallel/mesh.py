"""The data axis of a run (counterpart of ``cfdbench_tpu/parallel/mesh.py``).

The JAX package builds a ``(data, model)`` mesh of devices, keeps the
parameters replicated, shards each global batch's leading axis in
contiguous blocks over ``data`` (``P("data")``) and lets XLA insert the
reductions. The port runs data parallelism (dp) as one process a rank,
launched by ``torchrun``, and makes those reductions explicit:

- every rank builds the same global batch, padded to a multiple of the
  rank count with weight-0 rows, and takes its block of rows
  (:meth:`DataMesh.block`), rank r the rows ``[r B/N, (r+1) B/N)``;
- a random draw is made over the global shape from the same key on
  every rank and then sliced (:meth:`DataMesh.global_shape`, ``block``),
  so a rank draws what a single device draws for its rows;
- the loss and every score are over the global batch: each rank sums
  its partial sums over the group (:meth:`DataMesh.sum`, differentiable)
  and so computes the same loss as every other rank;
- after the backward the parameter gradients are averaged over the ranks
  in one flat all-reduce (:meth:`DataMesh.average_gradients`). The
  backward of :meth:`DataMesh.sum` sums the upstream gradients of every
  rank, and every rank holds the same loss, so each rank's gradient is N
  times its share: their average is the single-device gradient.

``--mesh_shape NxM`` lays the ranks out as the JAX package lays its
devices out, ``reshape(N, M)``: world rank r has data index ``r // M``
and model index ``r % M``. The ranks of one model index form a data
group, over which every reduction above runs (model ranks hold the same
rows: a sum over the world would count them M times); the ranks of one
data index form a model group (:class:`ModelAxis`), over which tensor
parallelism (``sharding_rules.py``, ``tensor.py``) and pipeline
parallelism (``pipeline.py``) exchange. Rank 0 of the world writes the
run's files; :meth:`DataMesh.barrier` waits for it over the world.

Under spatial sharding (``--shard_spatial 1``, ``spatial.py``) the model
ranks of a data rank hold the same batch rows but each its block of the
grid rows, as the JAX package's ``P(data, model)`` places a field: a
field's sums (the loss's, BatchNorm's) then run over every rank of the
world, :meth:`DataMesh.cells`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist


def parse_spec(spec: str) -> Tuple[Optional[int], int]:
    """``(data, model)`` sizes of a ``--mesh_shape``: ``auto`` (data None:
    every rank of the run), ``N`` or ``NxM``."""
    try:
        if spec == "auto":
            return None, 1
        if "x" in spec:
            d, m = (int(s) for s in spec.split("x"))
        else:
            d, m = int(spec), 1
    except ValueError:
        raise ValueError(f"--mesh_shape {spec!r}: give auto, N or NxM") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh_shape {spec!r}: sizes must be at least 1")
    return d, m


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def launched_world_size() -> int:
    """The ranks of this run: the initialised process group's size, else
    ``WORLD_SIZE`` as ``torchrun`` sets it, else 1."""
    if _initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def data_size(spec: str) -> int:
    """The data-axis size a ``--mesh_shape`` asks of this run, without
    opening a group: ``auto`` is every rank of it."""
    d, _ = parse_spec(spec)
    return launched_world_size() if d is None else d


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (SUM) whose backward all-reduces the upstream gradients:
    the output of every rank depends on the input of every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ModelAxis:
    """The model axis of a mesh: ``size`` ranks that hold the same rows of
    the batch, this process index ``rank`` among them, over ``group``."""

    def __init__(self, size: int = 1, rank: int = 0, group=None):
        self.size, self.rank, self.group = size, rank, group

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model ranks, differentiably: the backward
        sums the upstream gradients over them too (spatial sharding's row
        sums, ``spatial.py``)."""
        if not self.distributed:
            return x
        return _SumOverRanks.apply(x, self.group)

    def __repr__(self) -> str:
        return f"ModelAxis(size={self.size}, rank={self.rank})"


class DataMesh:
    """The data axis: ``size`` ranks, this process rank ``rank``, over
    ``group``; ``model`` is the mesh's model axis and ``world`` the group
    of every rank (``world_size`` of them). With one rank (no group, or a
    launcher's group of one) every method is the identity and no
    collective runs: a run under ``torchrun --nproc_per_node 1`` steps as
    one process does. With more, every rank must make the same calls in
    the same order."""

    def __init__(self, size: int = 1, rank: int = 0, group=None, model: ModelAxis = None,
                 world=None):
        self.size, self.rank, self.group = size, rank, group
        self.model = ModelAxis() if model is None else model
        self.world = group if world is None else world
        self.world_size = size * self.model.size

    @property
    def distributed(self) -> bool:
        """Whether the methods run collectives: more than one rank."""
        return self.size > 1

    def __repr__(self) -> str:
        backend = dist.get_backend(self.world) if self.world is not None else None
        model = f", model={self.model.size}" if self.model.distributed else ""
        return f"DataMesh(size={self.size}, rank={self.rank}{model}, backend={backend})"

    def is_main(self) -> bool:
        """Whether this rank writes the run's files: rank 0 of the world."""
        return self.rank == 0 and self.model.rank == 0

    def rows(self, H: int) -> Tuple[int, int]:
        """``(r0, h)``: the grid rows ``[r0, r0 + h)`` of an H-row grid that
        this model rank holds under spatial sharding, as ``P(data, model)``
        places them. Rows are never padded: H must divide by the model
        axis's size M, else ValueError names H, M and the flag (the JAX
        package's ``device_put`` refuses such a grid too)."""
        M = self.model.size
        if H % M:
            raise ValueError(f"--shard_spatial 1: a grid of H={H} rows does not split over a "
                             f"model axis of M={M} ranks (H must divide by M; rows are never "
                             "padded)")
        h = H // M
        return self.model.rank * h, h

    def cells(self) -> "DataMesh":
        """The mesh whose ranks each hold one block of a field under spatial
        sharding, a block of batch rows by a block of grid rows: every rank
        of the world, world rank ``rank * M + model rank``. Its sums and
        maxima run over the world; so its :meth:`sum` of per-rank partial
        sums is the whole field's (the loss's and BatchNorm's sums)."""
        if self.world_size == 1:
            return self
        return DataMesh(self.world_size, self.rank * self.model.size + self.model.rank,
                        self.world)

    def barrier(self) -> None:
        """Every rank of the world waits for the others."""
        if self.world_size > 1:
            dist.barrier(group=self.world)

    def global_shape(self, shape) -> Tuple[int, ...]:
        """The global batch's shape of a block of ``shape``."""
        shape = tuple(shape)
        return (shape[0] * self.size,) + shape[1:]

    def block(self, x):
        """This rank's rows of a global batch: a tensor, a numpy array, or
        a dict of them. The row count must divide by the size."""
        if isinstance(x, dict):
            return {k: self.block(v) for k, v in x.items()}
        if not self.distributed:
            return x
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        b = n // self.size
        return x[self.rank * b: (self.rank + 1) * b]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, differentiably (see the module's
        docstring for the gradient)."""
        if not self.distributed:
            return x
        return _SumOverRanks.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s elementwise maximum over the ranks, without a gradient."""
        if not self.distributed:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def weighted_mean(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the global batch's rows weighted by ``w``,
        ``Σ w·x / max(Σ w, 1)``, differentiably and in one reduction:
        ``x`` (rows, ...) and ``w`` (rows,) are this rank's block, the
        result has ``x.shape[1:]``. Weight-0 padding rows count for
        nothing."""
        wx = (x * w.reshape((-1,) + (1,) * (x.dim() - 1))).sum(0)
        sums = self.sum(torch.cat([wx.reshape(-1), w.sum().reshape(1)]))
        return (sums[:-1] / sums[-1].clamp(min=1.0)).reshape(x.shape[1:])

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of every rank's block ``x``, in rank order, on
        every rank, without a gradient: each block placed in zeros and the
        whole summed, an all-reduce, which every backend takes on the card
        (gloo has no all-gather of CUDA tensors)."""
        if not self.distributed:
            return x
        out = x.new_zeros(self.global_shape(x.shape))
        self.block(out).copy_(x)
        dist.all_reduce(out, group=self.group)
        return out

    def average_gradients(self, params) -> None:
        """Replace each parameter's gradient by its mean over the ranks, in
        one all-reduce of the gradients laid end to end. A parameter
        without a gradient has none on any rank (they run one program)."""
        if not self.distributed:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.size)
        for g, piece in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(piece.view_as(g))

    def sum_over_model(self, params, mean: bool = False) -> None:
        """Replace each parameter's gradient by its sum (``mean``: its mean)
        over the model ranks, in one all-reduce: the sum for the replicated
        parameters that a rank uses in part (tensor parallelism) or on one
        stage (pipeline parallelism), the mean for those that every model
        rank uses whole, so that kernels whose sums run in no fixed order
        (cuDNN's weight gradients) leave the replicas equal. A missing
        gradient counts as zeros."""
        params = list(params)
        if not self.model.distributed or not params:
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=self.model.group)
        if mean:
            flat.div_(self.model.size)
        for p, piece in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(piece.view_as(p))


SINGLE = DataMesh()


def make_mesh(spec: str = "auto", group=None) -> DataMesh:
    """The mesh of ``--mesh_shape spec`` over ``group`` (None: one
    process). ``auto`` takes every rank on the data axis; ``N`` and ``NxM``
    must multiply to the group's size. Every rank creates every data and
    model group of more than one rank, in the same order."""
    d, m = parse_spec(spec)
    world = dist.get_world_size(group) if group is not None else 1
    if d is None:
        d = world // m
    if d * m != world:
        raise ValueError(
            f"--mesh_shape {spec} asks for {d * m} ranks ({d} data x {m} model), but this run "
            f"has {world}: launch it as `torchrun --nproc_per_node {d * m} ...` (or pass "
            "--mesh_shape auto)")
    rank = dist.get_rank(group) if group is not None else 0
    if m == 1:
        return DataMesh(world, rank, group)
    ranks = dist.get_process_group_ranks(group)
    data_groups = [_new_group([ranks[i * m + j] for i in range(d)]) for j in range(m)]
    model_groups = [_new_group([ranks[i * m + j] for j in range(m)]) for i in range(d)]
    i, j = divmod(rank, m)
    return DataMesh(d, i, data_groups[j], ModelAxis(m, j, model_groups[i]), world=group)


def _new_group(ranks):
    """A group of ``ranks`` (None for one rank, which runs no collective);
    every rank of the world must call it alike."""
    return dist.new_group(ranks) if len(ranks) > 1 else None


@contextlib.contextmanager
def open_mesh(spec: str, device) -> Iterator[DataMesh]:
    """The data axis an entry point runs on. It uses the process group the
    caller initialised, if there is one; else, under ``torchrun`` (which
    sets ``WORLD_SIZE``), it initialises one from the launcher's
    environment, NCCL for a CUDA ``device`` and gloo for the CPU, and
    destroys it on exit; else one process runs alone. ``device`` must be
    the rank's own, set current before (``utils/device.py``)."""
    created = False
    if not _initialized() and "WORLD_SIZE" in os.environ:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="env://")
        created = True
    try:
        yield make_mesh(spec, dist.group.WORLD if _initialized() else None)
    finally:
        if created:
            dist.destroy_process_group()
