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

Under data parallelism (``mesh``, ``parallel/mesh.py``) each rank holds a
block of the batch: its weighted sums and element count are summed over
the ranks and ``max|label|`` is their maximum, so every rank computes the
scores of the global batch, as the JAX package does inside one program
over the sharded batch. Under spatial sharding ``mesh`` is the mesh's
``cells`` (``parallel/mesh.py``): a rank holds a block of grid rows of a
block of the batch, and the sums and the maximum run over every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .parallel.mesh import SINGLE, DataMesh


def score_dict(
    preds: torch.Tensor,
    labels: torch.Tensor,
    normalize: bool,
    sample_weights: Optional[torch.Tensor] = None,
    mesh: DataMesh = SINGLE,
) -> Dict[str, torch.Tensor]:
    """The reference loss dict over a batch (leading axis).
    ``sample_weights`` is an optional (batch,) 0/1 tensor; None means
    every sample counts. With a distributed ``mesh`` the batch is this
    rank's block of the global one, over which the scores are taken."""
    err = preds - labels
    if sample_weights is None and not mesh.distributed:
        w = None
        mse = err.square().mean()
        mae = err.abs().mean()
        lab2 = labels.square().mean()
        lab1 = labels.abs().mean()
    else:
        w = err.new_ones(err.shape[:1]) if sample_weights is None else sample_weights
        w = w.reshape((-1,) + (1,) * (err.dim() - 1))
        sums = mesh.sum(torch.stack([
            (w * err.square()).sum(), (w * err.abs()).sum(), (w * labels.square()).sum(),
            (w * labels.abs()).sum(), w.sum() * (err.numel() // err.shape[0])]))
        denom = torch.clamp(sums[4], min=1.0)
        mse, mae, lab2, lab1 = (sums[i] / denom for i in range(4))
    result = dict(mse=mse, rmse=mse.sqrt(), mae=mae)
    if normalize:
        # Guard only the exactly-all-zero-labels case (an all-padding
        # batch, or a zero label field), detected through max|label|,
        # which cannot underflow where the summed energy can: tiny but
        # nonzero labels keep the reference's unguarded division. The
        # inner where keeps the gradient of the guarded branch finite
        # (0 * inf would be NaN).
        local = labels.abs() if w is None else w * labels.abs()
        # A rank that holds no row (a latent grid that leaves it none under
        # spatial sharding) adds no maximum.
        absmax = mesh.max(local.max() if local.numel() else local.new_zeros(()))
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
    key of the score that training minimises, :attr:`mesh` the data axis
    its scores reduce over."""

    def __init__(self, normalize: bool, objective: str, mesh: DataMesh = SINGLE):
        self.normalize = normalize
        self.objective = objective
        self.mesh = mesh

    def __call__(self, preds, labels, sample_weights=None):
        return score_dict(preds, labels, self.normalize, sample_weights=sample_weights,
                          mesh=self.mesh)

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
