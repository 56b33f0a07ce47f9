"""Migration helpers for artifacts written by the PyTorch reference (the
port's own copy of ``cfdbench_tpu/data/compat.py``, on its own
``params_to_vector`` and ``AutoDataset``).

The reference's cylinder dataset caches its preprocessed tensors with
``torch.save`` into ``dataset/cache/cylinder/<subset>/<split>/*.pt``
(``src/dataset/cylinder.py:477-541``: ``inputs.pt`` (N, 3, h, w),
``labels.pt``, ``case_ids.pt``, ``case_params.pt`` (list of dicts,
already normalized), ``all_features.pt``). A user migrating from the
reference can load such a cache directly into this framework's packed
:class:`AutoDataset` without re-reading the raw case tree.

The cache is read with ``torch.load(..., weights_only=False)``, as the
original reads it: it holds lists and dicts, not tensors alone, so load
only caches you trust.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .core import params_to_vector
from .datasets import AutoDataset


def auto_dataset_from_reference_cache(cache_split_dir) -> AutoDataset:
    """Load a reference-written ``*.pt`` cache split as an AutoDataset.

    The channel conventions follow the reference's train collate
    (``src/train_auto.py:33-58``): features channel 2 is the mask;
    inputs/labels keep the velocity channels.
    """
    d = Path(cache_split_dir)
    load = lambda name: torch.load(  # noqa: E731
        d / name, map_location="cpu", weights_only=False
    )
    inputs = np.asarray(load("inputs.pt"), np.float32)  # (N, 3, h, w)
    labels = np.asarray(load("labels.pt"), np.float32)
    case_ids = np.asarray(load("case_ids.pt"), np.int32)
    case_params_list = load("case_params.pt")  # list of dicts per case
    all_features = [
        np.asarray(f, np.float32).transpose(0, 2, 3, 1)
        for f in load("all_features.pt")
    ]

    nhwc = lambda a: np.ascontiguousarray(  # noqa: E731
        a.transpose(0, 2, 3, 1)
    )
    params = np.stack(
        [
            params_to_vector(case_params_list[int(c)])
            for c in case_ids
        ]
    )
    return AutoDataset(
        inputs=nhwc(inputs[:, :2]),
        labels=nhwc(labels[:, :2]),
        masks=nhwc(inputs[:, 2:3]),
        case_params=params,
        case_ids=case_ids,
        all_features=all_features,
        case_params_list=[dict(p) for p in case_params_list],
    )
