"""Rollout, checkpoints and the inference task."""
