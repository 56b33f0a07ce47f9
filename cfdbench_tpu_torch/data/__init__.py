"""Data for the port (counterpart of ``cfdbench_tpu/data``).

The port keeps its own copies of the JAX package's numpy data code
(case loaders, splits, the synthetic generator, the case-parameter
order: ``core.py``, ``datasets.py``, ``synthetic.py``) and reads files
with ``np.load``. ``get_dataset`` builds the non-autoregressive models'
frame datasets, ``get_auto_dataset`` the frame pairs of the
autoregressive ones. ``tests/test_torch_host.py`` holds the copies bit-equal to the JAX
package's on a seeded synthetic tree. ``load_test_cases`` turns a split
into the arrays the port's rollout takes.

``data_name`` is ``<problem>_<subsets>`` with problem in {cavity, tube,
dam, cylinder} and subsets any combination mentioning prop/bc/geo
(``src/dataset/__init__.py:12-125``). Splits are the seeded 80/10/10
case-level split.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import Args
from ..training.rollout import pad_case_features
from .core import PROBLEMS, collect_case_dirs, params_to_vector, split_cases
from .datasets import AutoDataset, FrameDataset, build_auto_dataset, build_frame_dataset
from .synthetic import generate_all

__all__ = ["AutoDataset", "FrameDataset", "generate_all", "get_auto_dataset", "get_dataset",
           "load_test_cases"]

SPLITS = ("train", "dev", "test")


def _parse(data_name: str) -> Tuple[str, str]:
    problem = data_name.split("_")[0]
    if problem not in PROBLEMS:
        raise ValueError(f"invalid problem: {problem}")
    return problem, data_name[len(problem) + 1:]


def get_dataset(
    data_name: str,
    data_dir: Path,
    norm_props: bool,
    norm_bc: bool,
    seed: int = 0,
) -> Tuple[FrameDataset, FrameDataset, FrameDataset]:
    """Frame datasets (train, dev, test) for the non-autoregressive models."""
    problem, subsets = _parse(data_name)
    case_dirs = collect_case_dirs(Path(data_dir) / problem, subsets)
    return tuple(
        build_frame_dataset(problem, s, norm_props, norm_bc)
        for s in split_cases(case_dirs, seed=seed)
    )


def get_auto_dataset(
    data_dir: Path,
    data_name: str,
    delta_time: float,
    norm_props: bool,
    norm_bc: bool,
    load_splits: Sequence[str] = SPLITS,
    seed: int = 0,
    stable_state_diff: float = 0.001,
    cache_dir=None,
) -> Tuple[Optional[AutoDataset], Optional[AutoDataset], Optional[AutoDataset]]:
    """Pair datasets (train, dev, test) for autoregressive models; a
    split not in ``load_splits`` is None and is not built."""
    if not delta_time > 0:
        raise ValueError(f"delta_time must be positive, got {delta_time}")
    problem, subsets = _parse(data_name)
    case_dirs = collect_case_dirs(Path(data_dir) / problem, subsets)
    out: List[Optional[AutoDataset]] = []
    for name, split_dirs in zip(SPLITS, split_cases(case_dirs, seed=seed)):
        out.append(
            build_auto_dataset(
                problem, split_dirs, norm_props=norm_props, norm_bc=norm_bc,
                delta_time=delta_time, stable_state_diff=stable_state_diff,
                cache_dir=cache_dir,
            ) if name in load_splits else None
        )
    return tuple(out)


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
