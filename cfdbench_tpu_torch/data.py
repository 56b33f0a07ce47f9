"""Data for the port (counterpart of ``cfdbench_tpu/data``).

The JAX package's data code — the loaders, the splits, the synthetic
cavity generator and the case-parameter order — is numpy only and
imports no JAX, so the port uses it as it is: both packages see the
same cases, padding and masks by construction. This module turns a
split into the arrays the port's rollout takes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from cfdbench_tpu.config import Args
from cfdbench_tpu.data import get_auto_dataset
from cfdbench_tpu.data.core import params_to_vector
from cfdbench_tpu.data.synthetic import generate_all

from .training.rollout import pad_case_features

__all__ = ["generate_all", "load_test_cases"]


def load_test_cases(args: Args, steps: int):
    """The test split named by ``args``, every case at once:
    ``(features (N, steps, H, W, C+1), case_params (N, P))``, float32,
    the features padded or cut to ``steps`` frames."""
    _, _, test_data = get_auto_dataset(
        data_dir=Path(args.data_dir),
        data_name=args.data_name,
        delta_time=args.delta_time,
        norm_props=bool(args.norm_props),
        norm_bc=bool(args.norm_bc),
        load_splits=["test"],
        seed=args.seed,
        cache_dir=args.cache_dir or None,
    )
    features = pad_case_features(test_data.all_features, steps)
    case_params = np.stack(
        [params_to_vector(p) for p in test_data.case_params_list]
    ).astype(np.float32)
    return features, case_params
