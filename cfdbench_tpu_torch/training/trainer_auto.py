"""Inference half of ``cfdbench_tpu/training/trainer_auto.py::AutoTask``:
what the multistep rollout needs from a task. Training is ROADMAP.md A8;
the point models' 1-channel feedback comes with them (A10).
"""

from __future__ import annotations

from torch import nn


class AutoTask:
    """Couples an autoregressive field model with its rollout contract."""

    def __init__(self, model: nn.Module):
        self.model = model

    def predict_frame(self, inputs, case_params, mask):
        """Full-field next-frame prediction (eval mode)."""
        return self.model(inputs, case_params, mask)

    @property
    def feedback_channels(self) -> int:
        """Channels carried through the rollout."""
        return self.model.out_chan
