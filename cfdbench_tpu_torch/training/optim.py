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
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Tuple

import torch


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


def make_adam(
    params: Iterable[torch.nn.Parameter],
    lr: float,
    gamma: float = 0.9,
    lr_step_size: int = 1,
    steps_per_epoch: int = 1,
    opt_state: str = "f32",
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """``(optimizer, scheduler)``: Adam with float32 (``"f32"``) or
    bfloat16 (``"bf16"``) moments, and the StepLR schedule as a
    ``LambdaLR`` to step once after every ``optimizer.step()``.
    ``"factored"`` (optax's adafactor in the JAX package) is not ported."""
    if opt_state == "f32":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif opt_state == "bf16":
        opt = AdamCompact(params, lr=lr)
    elif opt_state == "factored":
        raise NotImplementedError(
            "--opt_state_dtype factored: adafactor's factored moments are not "
            "ported (ROADMAP.md A18)"
        )
    else:
        raise ValueError(f"opt_state {opt_state!r}: choose f32 | bf16 | factored")
    schedule = step_lr_schedule(1.0, gamma, lr_step_size, steps_per_epoch)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


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
    vectors too. The norm of that vector decides the skip and the clip:
    a gradient whose squared sum overflows float32 counts as non-finite,
    where optax would clip it to 0. A skipped step feeds the moments a
    zero gradient at decay 1 and the parameters a zero update, selected on
    the device. The counters are float32 device scalars in the first
    parameter's state, so ``state_dict`` carries them. As in optax, the
    accumulator is cleared by multiplying it by 0 after each k-th call,
    so a micro-batch with a non-finite gradient stays in it (ROADMAP.md
    C)."""

    def __init__(self, params, lr: float, decay_steps: int, warmup_steps: int = 500,
                 weight_decay: float = 1e-5, grad_accum_steps: int = 1):
        super().__init__(params, dict(
            peak_lr=lr, decay_steps=decay_steps, warmup_steps=warmup_steps,
            weight_decay=weight_decay, grad_accum_steps=grad_accum_steps, mini_step=0))

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
        flat = torch.cat([p.new_zeros(p.numel()) if p.grad is None else p.grad.reshape(-1)
                          for p in params])
        k = g["grad_accum_steps"]
        if k > 1:
            acc, n = state["acc"], g["mini_step"]
            acc.add_((flat - acc) / (n + 1))
            g["mini_step"] = (n + 1) % k
            if n != k - 1:
                return
            flat = acc.clone()
            acc.mul_(0.0)
        norm = torch.linalg.vector_norm(flat)
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
                    grad_accum_steps: int = 1) -> GenCastAdamW:
    """The GenCast optimizer for ``total_steps`` micro-batches: its
    schedule counts optimizer steps, ``total_steps // grad_accum_steps``
    (``src/train_gencast.py:288``), and decays over at least
    ``warmup_steps + 1`` of them."""
    opt_steps = max(1, total_steps // max(1, grad_accum_steps))
    return GenCastAdamW(params, lr, decay_steps=max(opt_steps, warmup_steps + 1),
                        warmup_steps=warmup_steps, weight_decay=weight_decay,
                        grad_accum_steps=grad_accum_steps)
