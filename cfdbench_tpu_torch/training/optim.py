"""The trainers' optimizers (port of ``cfdbench_tpu/training/optim.py``
and of ``make_gencast_tx`` in ``cfdbench_tpu/training/trainer_gencast.py``).

Adam with a per-epoch StepLR, stepped per global step:

The reference trains with ``Adam(lr)`` and ``StepLR(step_size, gamma)``
stepped once per epoch (``src/train_auto.py:213-216, 280``). The JAX
package drives ``optax.adam`` with a staircase schedule over global
steps; here ``torch.optim.Adam`` (whose update is ``optax.adam``'s: b1
0.9, b2 0.999, eps 1e-8 outside the square root) takes its rate from a
``LambdaLR`` stepped after every optimizer step, so step ``k`` runs at
``lr(k)``, the count before the increment, as optax's
``scale_by_learning_rate`` reads it.

``--opt_state_dtype factored`` is :class:`Adafactor`, the chain that
``optax.adafactor(learning_rate=schedule)`` builds, on the same schedule.

Under tensor parallelism a parameter may be this rank's slice of a tensor
split over the model axis: Adam is elementwise and runs on the slice as it
is; Adafactor's means and block RMS are over the whole tensor, so it
reduces them over the model ranks (:class:`Adafactor`'s ``shards``).
:func:`state_shard_axis` says along which axis each tensor of a
parameter's state is split, for the one-process layout on disk.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import SINGLE, DataMesh


def step_lr_schedule(lr: float, gamma: float, step_size_epochs: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """``lr * gamma ** (epoch // step_size)``, ``epoch = step // steps_per_epoch``."""

    def schedule(step: int) -> float:
        return lr * gamma ** ((step // steps_per_epoch) // step_size_epochs)

    return schedule


class AdamCompact(torch.optim.Optimizer):
    """Adam whose moments are stored in ``state_dtype`` (bfloat16) while
    the update is computed in float32: ``scale_by_adam_compact`` of the
    JAX package, for wide models whose step is bound by the optimizer's
    traffic. The float32 weights are untouched; only the moments are
    rounded."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 state_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        self.state_dtype = state_dtype

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamCompact.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p, dtype=self.state_dtype)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=self.state_dtype)
                state["step"] += 1
                g = p.grad.float()
                m = b1 * state["exp_avg"].float() + (1 - b1) * g
                v = b2 * state["exp_avg_sq"].float() + (1 - b2) * g * g
                bc1 = 1 - b1 ** state["step"]
                bc2 = 1 - b2 ** state["step"]
                p.add_((m / bc1) / ((v / bc2).sqrt() + group["eps"]), alpha=-group["lr"])
                state["exp_avg"].copy_(m)
                state["exp_avg_sq"].copy_(v)

    def load_state_dict(self, state_dict) -> None:
        # torch.optim casts floating state to its parameter's dtype on
        # load; the moments go back to their storage type.
        super().load_state_dict(state_dict)
        for state in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                state[key] = state[key].to(self.state_dtype)


# optax.adafactor's default: a tensor factors when two of its axes are
# at least this long.
MIN_DIM_SIZE_TO_FACTOR = 128


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """``(d1, d0)``: the second largest and the largest axis of ``shape``,
    over which Adafactor keeps its row and column statistics; None when
    the tensor has fewer than two axes or its second largest is below
    ``MIN_DIM_SIZE_TO_FACTOR`` (optax's ``_factored_dims``; equal sizes
    are ordered as ``np.argsort`` orders them)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(learning_rate=lr)`` as one optimizer step (the
    JAX package's ``--opt_state_dtype factored``, without weight decay, as
    ``main_auto`` passes none), per parameter tensor in the chain's order:

    1. ``scale_by_factored_rms``: with ``t`` the step count before the
       increment, decay ``1 - (t + 1) ** -0.8``; of ``g² + 1e-30``, a
       tensor with two axes of at least 128 (:func:`factored_dims`) keeps
       the running means over its largest axis (``v_row``) and over its
       second largest (``v_col``) and divides ``g`` by
       ``sqrt(v_row / mean(v_row) · v_col)``; any other keeps the whole
       running mean ``v`` and divides by ``sqrt(v)``;
    2. ``clip_by_block_rms(1)``: the update divided by ``max(1, rms)``;
    3. ``scale_by_learning_rate``: times the group's ``lr`` (a scheduler
       sets it, as ``make_adam`` does);
    4. ``scale_by_param_block_rms``: times ``max(rms(p), 1e-3)``;
    5. subtracted from the parameter.

    The factored estimate ``v_row_i · v_col_j / mean(v_row)`` is the same
    whichever of the two axes is called the row, so a torch ``(out, in)``
    weight gets the update of flax's ``(in, out)`` kernel.

    ``shards`` maps a parameter that holds this model rank's slice of a
    tensor split along an axis to that axis; ``axis`` is the mesh's model
    axis. Such a tensor factors by its whole shape, and its means over the
    split axis, its row mean and both RMS are summed over the model ranks
    (what the JAX package's sharded adafactor computes)."""

    DECAY_RATE = 0.8
    EPS = 1e-30
    CLIP = 1.0
    MIN_SCALE = 1e-3

    def __init__(self, params, lr: float, shards=None, axis=None):
        super().__init__(params, dict(lr=lr))
        self.shards, self.axis = shards or {}, axis

    def _mean(self, t: torch.Tensor, dim: int, split: Optional[int], keepdim: bool = False):
        """``t``'s mean over ``dim``, the whole tensor's where ``t`` is split
        along ``dim`` (``split``) over the model ranks."""
        if split != dim:
            return t.mean(dim, keepdim=keepdim)
        total = t.sum(dim, keepdim=keepdim)
        torch.distributed.all_reduce(total, group=self.axis.group)
        return total / (t.shape[dim] * self.axis.size)

    def _rms(self, t: torch.Tensor, split: Optional[int]) -> torch.Tensor:
        if split is None:
            return t.square().mean().sqrt()
        total = t.square().sum()
        torch.distributed.all_reduce(total, group=self.axis.group)
        return (total / (t.numel() * self.axis.size)).sqrt()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adafactor.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                split = self.shards.get(p)
                dims = factored_dims(whole_shape(p.shape, split, self.axis))
                if not state:
                    state["step"] = 0
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        state["v_row"] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d0])
                        state["v_col"] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d1])
                g = p.grad
                decay = 1.0 - (state["step"] + 1) ** -self.DECAY_RATE
                g2 = g * g + self.EPS
                if dims is None:
                    v = state["v"].mul_(decay).add_(g2, alpha=1.0 - decay)
                    update = g * v.rsqrt()
                else:
                    d1, d0 = dims
                    v_row = state["v_row"].mul_(decay).add_(self._mean(g2, d0, split),
                                                            alpha=1.0 - decay)
                    v_col = state["v_col"].mul_(decay).add_(self._mean(g2, d1, split),
                                                            alpha=1.0 - decay)
                    row_split = _without(split, d0)
                    row_mean = self._mean(v_row, d1 - 1 if d1 > d0 else d1, row_split,
                                          keepdim=True)
                    update = (g * (v_row / row_mean).rsqrt().unsqueeze(d0)
                              * v_col.rsqrt().unsqueeze(d1))
                state["step"] += 1
                rms = self._rms(update, split)
                update.div_(torch.clamp(rms / self.CLIP, min=1.0))
                p_rms = self._rms(p, split)
                scale = torch.where(p_rms <= self.MIN_SCALE, self.MIN_SCALE, p_rms)
                p.sub_(update.mul_(group["lr"]).mul_(scale))


def whole_shape(shape, split: Optional[int], axis) -> Tuple[int, ...]:
    """The whole tensor's shape of a slice of ``shape`` split along
    ``split`` over ``axis``'s ranks."""
    shape = list(shape)
    if split is not None:
        shape[split] *= axis.size
    return tuple(shape)


def _without(split: Optional[int], removed: int) -> Optional[int]:
    """Where a split axis lands once axis ``removed`` is reduced away (None
    if it was that axis)."""
    if split is None or split == removed:
        return None
    return split - (split > removed)


def state_shard_axis(optimizer, key: str, shape, split: Optional[int]) -> Optional[int]:
    """The axis along which ``key`` of the state of a parameter (whole
    shape ``shape``) split along ``split`` is split; None for a state
    entry every rank holds whole (a step count, or Adafactor's statistic
    over the split axis)."""
    if split is None or key == "step":
        return None
    if isinstance(optimizer, Adafactor) and key in ("v_row", "v_col"):
        d1, d0 = factored_dims(shape)
        return _without(split, d0 if key == "v_row" else d1)
    return split


def make_adam(
    params: Iterable[torch.nn.Parameter],
    lr: float,
    gamma: float = 0.9,
    lr_step_size: int = 1,
    steps_per_epoch: int = 1,
    opt_state: str = "f32",
    shards=None,
    axis=None,
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """``(optimizer, scheduler)``: Adam with float32 (``"f32"``) or
    bfloat16 (``"bf16"``) moments, or :class:`Adafactor` (``"factored"``,
    given the ``shards`` of tensor parallelism over ``axis``), and the
    StepLR schedule as a ``LambdaLR`` to step once after every
    ``optimizer.step()``."""
    if opt_state == "f32":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif opt_state == "bf16":
        opt = AdamCompact(params, lr=lr)
    elif opt_state == "factored":
        opt = Adafactor(params, lr=lr, shards=shards, axis=axis)
    else:
        raise ValueError(f"opt_state {opt_state!r}: choose f32 | bf16 | factored")
    schedule = step_lr_schedule(1.0, gamma, lr_step_size, steps_per_epoch)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


# The JAX GenCast trainer's fixed settings of its optax chain.
CLIP_NORM = 1.0
MAX_CONSECUTIVE_ERRORS = 100


def warmup_cosine(count: torch.Tensor, peak: float, warmup: int, decay_steps: int) -> torch.Tensor:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup, decay_steps,
    end_value=0)`` at ``count`` applied updates, a float32 device scalar."""
    warm = -peak * (1.0 - count.clamp(max=warmup) / warmup) + peak
    span = decay_steps - warmup
    cosine = peak * (0.5 * (1.0 + torch.cos(math.pi * (count - warmup).clamp(0, span) / span)))
    return torch.where(count < warmup, warm, cosine)


class GenCastAdamW(torch.optim.Optimizer):
    """The JAX GenCast trainer's optax chain as one optimizer step, in its
    order:

    1. ``optax.MultiSteps(k)`` (k > 1): the gradients of k micro-batches
       are averaged, ``acc + (g − acc) / (n + 1)``, and the rest runs on
       every k-th call; the others leave the parameters as they are;
    2. ``apply_if_finite(MAX_CONSECUTIVE_ERRORS)``: averaged gradients with
       a NaN or an infinity skip the update (moments and schedule
       untouched) unless more than that many consecutive ones did;
    3. ``clip_by_global_norm(CLIP_NORM)``;
    4. ``adamw``: Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root) plus
       optax's decoupled decay, ``p ← p − lr · (adam + wd · p)``;
    5. ``warmup_cosine_decay_schedule``: 0 up to ``lr`` over
       ``warmup_steps`` applied updates, then down to 0 at
       ``decay_steps``.

    The step reads nothing back to the host. The gradients are gathered
    into one flat vector, and the moments and the accumulator are flat
    vectors too. Under data parallelism (``mesh``) each rank's vector is
    averaged over the ranks in one all-reduce before step 1, so that the
    accumulator, the gate, the clip and AdamW all see the single-device
    gradient, and a non-finite gradient on one rank skips the update on
    every rank. :attr:`grad_norm` is the global norm of the last
    (averaged) micro-batch gradient, a device scalar, for the log. The norm of that vector decides the skip and the clip:
    a gradient whose squared sum overflows float32 counts as non-finite,
    where optax would clip it to 0. A skipped step feeds the moments a
    zero gradient at decay 1 and the parameters a zero update, selected on
    the device. The counters are float32 device scalars in the first
    parameter's state, so ``state_dict`` carries them. As in optax, the
    accumulator is cleared by multiplying it by 0 after each k-th call,
    so a micro-batch with a non-finite gradient stays in it (ROADMAP.md
    C).

    Under tensor parallelism (``split``, the model's
    ``trainer_auto.ModelSplit``) a rank's vectors hold the slices of the
    split parameters and the whole replicated ones, whose gradients are
    first averaged over the model ranks. The global norm is then the whole
    tree's, alike on every rank, in one all-reduce of a scalar over the
    model ranks: each rank's squares weighted 1 on its slices and 1/M on the
    replicated elements, which every model rank holds alike, summed over
    the M ranks. So a skip or a clip happens on every rank or on none.
    ``checkpoints.optimizer_to_std`` and ``optimizer_from_std`` carry the
    flat vectors (``FLAT``) in the one-process layout
    (``ShardedLayout.flat_to_std``)."""

    FLAT = ("mu", "nu", "acc")  # the state vectors laid out as the parameters

    def __init__(self, params, lr: float, decay_steps: int, warmup_steps: int = 500,
                 weight_decay: float = 1e-5, grad_accum_steps: int = 1,
                 mesh: DataMesh = SINGLE, split=None):
        super().__init__(params, dict(
            peak_lr=lr, decay_steps=decay_steps, warmup_steps=warmup_steps,
            weight_decay=weight_decay, grad_accum_steps=grad_accum_steps, mini_step=0))
        self.mesh, self.split = mesh, split
        self.grad_norm: Optional[torch.Tensor] = None
        self._norm_weights: Optional[torch.Tensor] = None
        if split is not None:
            params = self.param_groups[0]["params"]
            first = params[0]
            axes = [split.layout.shard_axis(n) for n in split.layout.local_names]
            if len(axes) != len(params):
                raise ValueError(f"{len(params)} parameters against a layout of {len(axes)}")
            self._norm_weights = torch.cat([
                first.new_full((p.numel(),), 1.0 if a is not None else 1.0 / mesh.model.size)
                for p, a in zip(params, axes)])

    def _norm(self, flat: torch.Tensor) -> torch.Tensor:
        """The global norm of the tree whose local vector is ``flat``."""
        if self._norm_weights is None:
            return torch.linalg.vector_norm(flat)
        sq = torch.dot(flat.square(), self._norm_weights)
        torch.distributed.all_reduce(sq, group=self.mesh.model.group)
        return sq.sqrt()

    def _flat_state(self) -> dict:
        group = self.param_groups[0]
        first = group["params"][0]
        state = self.state[first]
        if not state:
            n = sum(p.numel() for p in group["params"])

            def zeros(*shape):
                return torch.zeros(shape, dtype=first.dtype, device=first.device)

            state.update(mu=zeros(n), nu=zeros(n), count=zeros(), notfinite_count=zeros())
            if group["grad_accum_steps"] > 1:
                state["acc"] = zeros(n)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("GenCastAdamW.step takes no closure")
        g = self.param_groups[0]
        params = g["params"]
        state = self._flat_state()
        if self.split is not None:
            self.mesh.sum_over_model(self.split.averaged, mean=True)
        flat = torch.cat([p.new_zeros(p.numel()) if p.grad is None else p.grad.reshape(-1)
                          for p in params])
        if self.mesh.distributed:
            flat = self.mesh.sum(flat).div_(self.mesh.size)
        self.grad_norm = self._norm(flat)
        k = g["grad_accum_steps"]
        if k > 1:
            acc, n = state["acc"], g["mini_step"]
            acc.add_((flat - acc) / (n + 1))
            g["mini_step"] = (n + 1) % k
            if n != k - 1:
                return
            flat = acc.clone()
            acc.mul_(0.0)
            norm = self._norm(flat)
        else:
            norm = self.grad_norm
        finite = torch.isfinite(norm)
        notfinite = state["notfinite_count"]
        notfinite.copy_(torch.where(finite, 0.0, notfinite + 1))
        apply = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
        flat.mul_(torch.where(norm < CLIP_NORM, 1.0, CLIP_NORM / norm))
        flat = torch.where(apply, flat, 0.0)
        b1, b2, eps = 0.9, 0.999, 1e-8
        mu, nu, count = state["mu"], state["nu"], state["count"]
        mu.mul_(torch.where(apply, b1, 1.0)).add_(flat * torch.where(apply, 1 - b1, 0.0))
        nu.mul_(torch.where(apply, b2, 1.0)).add_(
            flat.square_().mul_(torch.where(apply, 1 - b2, 0.0)))
        lr = warmup_cosine(count, g["peak_lr"], g["warmup_steps"], g["decay_steps"])
        count.add_(apply.to(count.dtype))
        applied = count.clamp(min=1)
        update = (mu / (1 - b1 ** applied)).div_((nu / (1 - b2 ** applied)).sqrt_().add_(eps))
        update.add_(torch.cat([p.reshape(-1) for p in params]), alpha=g["weight_decay"])
        update.mul_(torch.where(apply, -lr, 0.0))
        torch._foreach_add_(params, [u.view_as(p) for u, p in zip(
            update.split([p.numel() for p in params]), params)])


def make_gencast_tx(params: Iterable[torch.nn.Parameter], lr: float, total_steps: int,
                    warmup_steps: int = 500, weight_decay: float = 1e-5,
                    grad_accum_steps: int = 1, mesh: DataMesh = SINGLE,
                    split=None) -> GenCastAdamW:
    """The GenCast optimizer for ``total_steps`` micro-batches: its
    schedule counts optimizer steps, ``total_steps // grad_accum_steps``
    (``src/train_gencast.py:288``), and decays over at least
    ``warmup_steps + 1`` of them; its gradients averaged over ``mesh``, its
    parameters laid over the model axis as ``split`` lays them."""
    opt_steps = max(1, total_steps // max(1, grad_accum_steps))
    return GenCastAdamW(params, lr, decay_steps=max(opt_steps, warmup_steps + 1),
                        warmup_steps=warmup_steps, weight_decay=weight_decay,
                        grad_accum_steps=grad_accum_steps, mesh=mesh, split=split)
