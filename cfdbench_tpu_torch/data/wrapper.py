"""GenCast triple-frame wrapper and residual statistics (the port's copy
of ``cfdbench_tpu/data/wrapper.py``, held to it bit for bit by
``tests/test_torch_host.py``).

Mirror of ``src/dataset/wrapper.py`` (packed): wraps an ``AutoDataset``
into (X_{t−2}, X_{t−1}, X_t) triples, keeping only indices whose
predecessor pair belongs to the same case, and of
``src/utils/calculate_residuals_stat.py:78-158`` (two-pass per-channel
mean/std of the residual X_t − X_{t−1} over the train split; std
clamped to ≥1e-6). Stats are saved as ``residual_stats.npz`` (the
reference uses ``residual_stats.pt``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np

from .datasets import AutoDataset


@dataclass
class GenCastDataset:
    inputs: np.ndarray        # X_{t-1}: (N, H, W, 2)
    inputs_prev: np.ndarray   # X_{t-2}: (N, H, W, 2)
    labels: np.ndarray        # X_t:     (N, H, W, 2)
    masks: np.ndarray         # (N, H, W, 1)
    case_params: np.ndarray   # (N, P)

    def __len__(self):
        return self.inputs.shape[0]

    @property
    def field_shape(self):
        return self.inputs.shape[1:3]

    @property
    def n_case_params(self):
        return self.case_params.shape[1]


def wrap_gencast(base: AutoDataset) -> GenCastDataset:
    ids = base.case_ids
    valid = np.nonzero(
        (np.arange(len(ids)) > 0) & (ids == np.roll(ids, 1))
    )[0]
    assert valid.size > 0, "no valid (t-2, t-1, t) triples"
    return GenCastDataset(
        inputs=base.inputs[valid],
        inputs_prev=base.inputs[valid - 1],
        labels=base.labels[valid],
        masks=base.masks[valid],
        case_params=base.case_params[valid],
    )


def compute_residual_stats(data) -> Dict[str, np.ndarray]:
    """Per-channel mean/std of X_t − X_{t−1} (exact two-pass math of
    the reference; vectorized)."""
    residuals = (data.labels - data.inputs).astype(np.float64)
    mean = residuals.mean(axis=(0, 1, 2))
    std = np.sqrt(((residuals - mean) ** 2).mean(axis=(0, 1, 2)))
    std = np.maximum(std, 1e-6)
    return dict(
        residual_mean=mean.astype(np.float32),
        residual_std=std.astype(np.float32),
    )


def save_residual_stats(stats: Dict[str, np.ndarray], path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **stats)


def load_residual_stats(path) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return dict(residual_mean=z["residual_mean"],
                    residual_std=z["residual_std"])
