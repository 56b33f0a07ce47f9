"""Optimizer, checkpoints, the autoregressive trainer and the rollout."""
