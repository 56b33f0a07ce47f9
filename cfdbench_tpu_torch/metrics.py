"""Loss / metric semantics of the CFDBench reference (port of
``cfdbench_tpu/metrics.py``).

- ``mse``  = mean((preds - labels)**2) over every element
- ``rmse`` = sqrt(mse)
- ``mae``  = mean(|preds - labels|)
- ``nmse`` = mse / mean(labels**2), ``nmae`` = mae / mean(|labels|)
  (only when ``normalize``)

These functions never mask: field models multiply preds and labels by
the geometry mask before the loss, as the reference does. Optional 0/1
per-sample weights make a padded batch score exactly like the unpadded
one (``data/pipeline.py`` pads the last batch of an epoch).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def score_dict(
    preds: torch.Tensor,
    labels: torch.Tensor,
    normalize: bool,
    sample_weights: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The reference loss dict over a batch (leading axis).
    ``sample_weights`` is an optional (batch,) 0/1 tensor; None means
    every sample counts."""
    err = preds - labels
    if sample_weights is None:
        mse = err.square().mean()
        mae = err.abs().mean()
        lab2 = labels.square().mean()
        lab1 = labels.abs().mean()
    else:
        w = sample_weights.reshape((-1,) + (1,) * (err.dim() - 1))
        denom = torch.clamp(w.sum() * (err.numel() // err.shape[0]), min=1.0)
        mse = (w * err.square()).sum() / denom
        mae = (w * err.abs()).sum() / denom
        lab2 = (w * labels.square()).sum() / denom
        lab1 = (w * labels.abs()).sum() / denom
    result = dict(mse=mse, rmse=mse.sqrt(), mae=mae)
    if normalize:
        # Guard only the exactly-all-zero-labels case (an all-padding
        # batch, or a zero label field), detected through max|label|,
        # which cannot underflow where the summed energy can: tiny but
        # nonzero labels keep the reference's unguarded division. The
        # inner where keeps the gradient of the guarded branch finite
        # (0 * inf would be NaN).
        absmax = (labels.abs() if sample_weights is None else w * labels.abs()).max()
        valid = absmax > 0
        result["nmse"] = torch.where(valid, mse / torch.where(valid, lab2, 1.0), 0.0)
        result["nmae"] = torch.where(valid, mae / torch.where(valid, lab1, 1.0), 0.0)
    return result


def score_names(normalize: bool) -> list:
    """Mirror of ``MseLoss.get_score_names`` (``src/models/loss.py:14-20``)."""
    names = ["mse", "rmse", "mae"]
    if normalize:
        names.append("nmse")
    return names


class LossFn:
    """The reference ``MseLoss`` as a callable; :attr:`objective` is the
    key of the score that training minimises."""

    def __init__(self, normalize: bool, objective: str):
        self.normalize = normalize
        self.objective = objective

    def __call__(self, preds, labels, sample_weights=None):
        return score_dict(preds, labels, self.normalize, sample_weights=sample_weights)

    def get_score_names(self):
        names = score_names(self.normalize)
        # The reference's names never include nmae (SURVEY.md §8 defect
        # #7); only the nmae objective adds it.
        if self.objective == "nmae" and "nmae" not in names:
            names.append("nmae")
        return names


def loss_name_to_fn(name: str) -> LossFn:
    """Mirror of ``src/models/loss.py:40-50``, with mae and nmae (which
    the reference advertises but does not implement) supported."""
    name = name.lower()
    if name in ("mse", "nmse", "mae", "nmae"):
        return LossFn(normalize=name.startswith("n"), objective=name)
    raise NotImplementedError(f"unknown loss name: {name}")
