"""Adam with a per-epoch StepLR, stepped per global step (port of
``cfdbench_tpu/training/optim.py``).

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

from typing import Callable, Iterable, Tuple

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
