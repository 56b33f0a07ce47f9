"""The model-axis operators of tensor parallelism (tp), as autograd
Functions over a mesh's model axis (``mesh.ModelAxis``: ``size``, ``rank``,
``group``).

The JAX package shards parameters with ``NamedSharding`` and lets XLA
insert the collectives (``cfdbench_tpu/parallel/sharding_rules.py``).
Here they are explicit:

- :func:`gather_channels`: each rank's slice of the last axis, gathered
  into the whole; the backward takes this rank's slice of the gradient.
  The column-parallel FNO block's output (``models/fno.py``).
- :func:`reduce_model`: a sum over the model ranks; the backward passes
  the gradient through (every rank holds the same loss). The row-parallel
  head's partial outputs.
- :func:`copy_to_model`: the identity; the backward sums the gradient over
  the model ranks, each of which computed only its slice's share. The
  input of a column- or row-parallel layer.
- :func:`gather_at_use` installs, on every module that owns a sharded
  parameter, hooks that gather the parameter's slices into the whole for
  the module's forward (:class:`GatherShard`: all-gather forward, slice of
  the gradient backward, no reduction over the model ranks, since every
  model rank computes the same whole gradient and each owns its slice).
  Every model but the FNO runs this way under tp: in ``main_auto`` and
  the autoregressive rollout the U-Net, the ResNet, the FFNO, the point
  models, pixel diffusion and the latent models' UNet; GenCast's PUNetG in
  ``main_gencast`` and its rollout, the VAE in ``main_vae``, and the
  unconditional DDPM's PUNetG and its EMA copy in ``main_uncond``
  (``training/trainer_auto.py::split_module``). Their parameters and
  optimizer moments are stored 1/M a rank, as in the JAX package, and
  their compute is replicated over the model ranks. Under spatial
  sharding (``spatial.py``) every model runs this way, the hooks on the
  model itself (or on each part a latent model's task calls), all its
  split parameters gathered in one exchange (:class:`GatherShards`), and
  the gradient of a gathered parameter is the partial of the rank's rows:
  the backward averages it over the model ranks before taking the slice,
  a reduce-scatter.

Transport: every gather is an all-reduce of each rank's slice placed in
zeros, on every backend. Gloo, which carries two ranks on one card (NCCL
refuses two ranks on one device), has no all-gather of CUDA tensors but
all-reduces them through host memory; NCCL all-reduces on the card. With
one model rank every operator is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _slice(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n).contiguous()


def all_gather(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """The model ranks' tensors ``x``, concatenated along ``dim`` in rank
    order, on every rank, without a gradient."""
    shape = list(x.shape)
    shape[dim] *= axis.size
    out = x.new_zeros(shape)
    out.narrow(dim, axis.rank * x.shape[dim], x.shape[dim]).copy_(x)
    dist.all_reduce(out, group=axis.group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x.contiguous(), dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.axis.group)
        return grad, None


def gather_channels(x: torch.Tensor, axis) -> torch.Tensor:
    """(..., C/M) on each model rank → (..., C) on every one."""
    return x if not axis.distributed else _Gather.apply(x, x.dim() - 1, axis)


def reduce_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over the model ranks; the gradient passes through."""
    return x if not axis.distributed else _Reduce.apply(x, axis)


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself; its gradient summed over the model ranks."""
    return x if not axis.distributed else _Copy.apply(x, axis)


class GatherShard(torch.autograd.Function):
    """A parameter's slice on this rank → the whole parameter; the
    gradient's slice goes back, with no reduction over the model ranks
    (tp: every model rank computes the same whole gradient)."""

    @staticmethod
    def forward(ctx, shard, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(shard.detach(), dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.axis), None, None


class GatherShards(torch.autograd.Function):
    """Several parameters' slices (``dims[i]`` the axis of ``shards[i]``,
    all of one dtype) → the whole parameters, in one all-reduce of their
    whole shapes laid end to end; backward, one all-reduce of their
    gradients, each averaged over the model ranks (sp: each rank's is the
    partial of its rows) before its slice goes back."""

    @staticmethod
    def forward(ctx, dims, axis, *shards):
        ctx.dims, ctx.axis = dims, axis
        wholes = []
        for shard, dim in zip(shards, dims):
            shape = list(shard.shape)
            shape[dim] *= axis.size
            wholes.append(shape)
        ctx.wholes = wholes
        flat = shards[0].new_zeros(sum(torch.Size(w).numel() for w in wholes))
        outs = [piece.view(w) for piece, w in zip(flat.split([torch.Size(w).numel() for w in wholes]),
                                                  wholes)]
        for out, shard, dim in zip(outs, shards, dims):
            out.narrow(dim, axis.rank * shard.shape[dim], shard.shape[dim]).copy_(shard)
        dist.all_reduce(flat, group=axis.group)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        # Grads of unused outputs come as zeros (materialized).
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.axis.group)
        flat.div_(ctx.axis.size)
        pieces = flat.split([torch.Size(w).numel() for w in ctx.wholes])
        return (None, None, *[_slice(p.view(w), d, ctx.axis)
                              for p, w, d in zip(pieces, ctx.wholes, ctx.dims)])


def gather_at_use(module: torch.nn.Module, shard_axes, axis, spatial: bool = False) -> list:
    """Hooks on each submodule of ``module`` that owns a parameter named in
    ``shard_axes`` (its name in ``module`` → the axis it is split on, or
    None): before the submodule's forward each such parameter is gathered
    into the whole (:class:`GatherShard`) and set in the submodule's
    ``__dict__``, where attribute lookup finds it before the parameter,
    and removed after. With ``spatial`` the hooks are on ``module`` itself
    and gather every split parameter for its whole forward (the FNO reads
    its submodules' weights without calling them) in one exchange, each
    gradient averaged over the model ranks (:class:`GatherShards`). The
    parameter itself stays this rank's slice: what the optimizer updates
    and ``state_dict`` holds. A
    cast copy that ``torch.func.functional_call`` puts in the parameter's
    place is gathered the same way. A module that is never called itself
    names in ``PARTS`` the submodules that are, each for its whole forward
    (a latent diffusion model's UNet and conditioning): with ``spatial``
    the hooks sit on each of those. Returns the hooks' handles."""
    owners, handles = {}, []
    for name, dim in shard_axes.items():
        if dim is not None:
            path, _, leaf = name.rpartition(".")
            owners.setdefault(path, []).append((leaf, dim))

    def group(path):
        if not spatial:
            return path
        return next((part for part in getattr(module, "PARTS", ())
                     if path == part or path.startswith(part + ".")), "")

    groups = {}
    for path, leaves in owners.items():
        groups.setdefault(group(path), []).extend(
            (module.get_submodule(path), leaf, dim) for leaf, dim in leaves)
    for path, leaves in groups.items():
        if not leaves:
            continue

        def gather(mod, args, leaves=leaves):
            if not spatial:
                for owner, leaf, dim in leaves:
                    owner.__dict__[leaf] = GatherShard.apply(owner._parameters[leaf], dim, axis)
                return
            by_dtype = {}  # one exchange for each dtype of the slices (a cast copy's)
            for owner, leaf, dim in leaves:
                shard = owner._parameters[leaf]
                by_dtype.setdefault(shard.dtype, []).append((owner, leaf, dim, shard))
            for group in by_dtype.values():
                wholes = GatherShards.apply(tuple(d for _, _, d, _ in group), axis,
                                            *[shard for *_, shard in group])
                for (owner, leaf, _, _), whole in zip(group, wholes):
                    owner.__dict__[leaf] = whole

        def release(mod, args, out, leaves=leaves):
            for owner, leaf, _ in leaves:
                owner.__dict__.pop(leaf, None)

        sub = module.get_submodule(path)
        handles += [sub.register_forward_pre_hook(gather), sub.register_forward_hook(release)]
    return handles


class ShardedLayout:
    """The parameters of ``module`` under tensor parallelism, each whole or
    this model rank's slice along the axis ``axes`` names (None: whole),
    and their one-process layout: :meth:`to_std` gathers a named set of
    tensors laid out as the parameters are (a state dict, an optimizer
    moment of each) over the model ranks, :meth:`from_std` slices it;
    :meth:`flat_to_std` and :meth:`flat_from_std` do the same for one
    vector of every parameter laid end to end in their order (GenCast's
    flat optimizer state). With no split axis all four are the identity."""

    def __init__(self, module: torch.nn.Module, axes, axis):
        self.axes, self.axis = dict(axes), axis
        self.local_names = [n for n, _ in module.named_parameters()]
        self.std_names = self.local_names
        self.shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}

    def shard_axis(self, name: str):
        return self.axes.get(name)

    def whole_shape(self, name: str):
        shape = list(self.shapes[name])
        if self.axes.get(name) is not None:
            shape[self.axes[name]] *= self.axis.size
        return tuple(shape)

    def to_std(self, local, axes=None):
        axes = self.axes if axes is None else axes
        return {n: t if axes.get(n) is None else all_gather(t.contiguous(), axes[n], self.axis)
                for n, t in local.items()}

    def from_std(self, std, axes=None):
        axes = self.axes if axes is None else axes
        return {n: t if axes.get(n) is None else _slice(t, axes[n], self.axis)
                for n, t in std.items()}

    def flat_to_std(self, flat: torch.Tensor) -> torch.Tensor:
        """A vector of this rank's parameters laid end to end → the
        one-process model's vector: each parameter's piece gathered over the
        model ranks, the whole ones laid end to end in the one-process
        order (a collective over the model ranks)."""
        pieces = flat.split([torch.Size(self.shapes[n]).numel() for n in self.local_names])
        std = self.to_std({n: t.view(self.shapes[n]) for n, t in zip(self.local_names, pieces)})
        return torch.cat([std[n].reshape(-1) for n in self.std_names])

    def flat_from_std(self, flat: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`flat_to_std`, without a collective."""
        pieces = flat.split([torch.Size(self.whole_shape(n)).numel() for n in self.std_names])
        local = self.from_std({n: t.view(self.whole_shape(n))
                               for n, t in zip(self.std_names, pieces)})
        return torch.cat([local[n].reshape(-1) for n in self.local_names])
