"""The reference model of a configuration, found by its ``model``: the module
``reference/<model>.py``, which provides ``initial_stats(config, P)``,
``predict(config, P, S, inputs, case_params, mask)`` (evaluation mode) and
``forward_macs(config, batch)``; and the rollout, the same for every
model."""

from __future__ import annotations

import importlib

import torch


def of(config: dict):
    """The module ``reference/<model>.py`` of the configuration."""
    try:
        return importlib.import_module(f"{__package__}.{config['model']}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no plain reference for model {config['model']!r}") from e


def initial_stats(config: dict, P) -> dict:
    """Running statistics before training (none for a model without norms)."""
    return of(config).initial_stats(config, P)


def predict(config: dict, P, S, inputs, case_params, mask):
    return of(config).predict(config, P, S, inputs, case_params, mask)


def forward_macs(config: dict, batch: int) -> int:
    """Multiply-adds of one forward of ``batch`` cases of the configuration."""
    return of(config).forward_macs(config, batch)


def rollout(config: dict, P, frame0, case_params, mask, steps: int):
    """``(steps, B, H, W, C)``: each frame predicted from the one before, on
    the running statistics of an untrained model."""
    S = initial_stats(config, P)
    frames, x = [], frame0
    with torch.no_grad():
        for _ in range(steps):
            x = predict(config, P, S, x, case_params, mask)
            frames.append(x)
    return torch.stack(frames)
