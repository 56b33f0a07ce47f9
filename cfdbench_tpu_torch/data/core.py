"""Case loading for the four CFDBench problems (the port's own copy of
``cfdbench_tpu/data/core.py``, reading files with ``np.load``).

Data contract (identical to the reference): a *case* is a directory with
``u.npy`` / ``v.npy`` of shape ``(T, H, W)`` plus ``case.json`` of scalar
parameters (``README.md:70-87``). Each problem applies its own boundary
padding and geometry mask:

- cavity  (``src/dataset/cavity.py:15-34``): no padding, mask = ones.
- tube    (``src/dataset/tube.py:15-52``): left edge padded with inlet BC
  ``vel_in`` (u) / 0 (v) / 0 (mask); top+bottom padded 0 → (H+2, W+1).
- dam     (``src/dataset/dam.py:51-110``): like tube, but the left BC
  column gets ``velocity`` only below the barrier top; params filtered to
  5 keys. The reference's barrier-mask slice is a no-op bug (defect #3);
  the *intended* barrier mask is behind ``fix_barrier_mask`` (default
  False = bit-compatible with the reference).
- cylinder (``src/dataset/cylinder.py:194-282``, the active ``_fix``
  loader): no padding (stays H×W), circular obstacle mask from physical
  center/radius, top/bottom/left boundary rows zeroed in the mask.

Features are NHWC, ``(T, H, W, 3)`` with channels ``[u, v, mask]``.
The splits, padding, masks and case-parameter order must stay bit-equal
to the JAX package's (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Hardcoded normalization stats (``src/dataset/utils.py:8-28``).
DENSITY_MEAN, DENSITY_STD = 5.0, 4.0
VISCOSITY_MEAN, VISCOSITY_STD = 0.00238, 0.005

# Per-problem boundary-condition key normalized by ``normalize_bc``.
BC_KEY = {
    "cavity": "vel_top",
    "tube": "vel_in",
    "dam": "velocity",
    "cylinder": "vel_in",
}

# Per-frame time delta in the raw data (``data_delta_time`` class attrs).
DATA_DELTA_TIME = {
    "cavity": 0.1,
    "tube": 0.1,
    "dam": 0.1,
    "cylinder": 0.001,  # src/dataset/cylinder.py:421-423
}

PROBLEMS = ("cavity", "tube", "dam", "cylinder")


def load_json(path) -> dict:
    with open(path, "r", encoding="utf8") as f:
        return json.load(f)


def dump_json(data, path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf8") as f:
        json.dump(data, f, indent=2, ensure_ascii=False)


def load_npy(path) -> np.ndarray:
    return np.load(path).astype(np.float32, copy=False)


def normalize_physics_props(case_params: Dict[str, float]) -> None:
    """In-place z-score of density/viscosity (``src/dataset/utils.py:8-21``)."""
    case_params["density"] = (
        case_params["density"] - DENSITY_MEAN
    ) / DENSITY_STD
    case_params["viscosity"] = (
        case_params["viscosity"] - VISCOSITY_MEAN
    ) / VISCOSITY_STD


def normalize_bc(case_params: Dict[str, float], key: str) -> None:
    """In-place BC velocity scaling (``src/dataset/utils.py:24-28``)."""
    case_params[key] = case_params[key] / 50 - 0.5


def params_to_vector(case_params: Dict[str, float]) -> np.ndarray:
    """Dict → float32 vector, excluding rotated/dx/dy, in insertion order.

    Mirrors the auto collate_fn (``src/train_auto.py:44-51``) and
    ``case_params_to_tensor`` (``src/test_multistep.py:85-92``).
    """
    keys = [
        k for k in case_params.keys()
        if k not in ("rotated", "dx", "dy", "__normalized__")
    ]
    return np.asarray([case_params[k] for k in keys], dtype=np.float32)


@dataclass
class CaseData:
    """One loaded case: NHWC features and its (possibly normalized) params."""

    features: np.ndarray  # (T, H, W, 3) float32, channels [u, v, mask]
    params: Dict[str, float]

    @property
    def num_frames(self) -> int:
        return self.features.shape[0]

    @property
    def params_vector(self) -> np.ndarray:
        return params_to_vector(self.params)


def _stack_nhwc(u: np.ndarray, v: np.ndarray, mask: np.ndarray) -> np.ndarray:
    return np.stack([u, v, mask], axis=-1).astype(np.float32)


def load_case_cavity(case_dir: Path) -> CaseData:
    params = load_json(case_dir / "case.json")
    u = load_npy(case_dir / "u.npy")
    v = load_npy(case_dir / "v.npy")
    mask = np.ones_like(u)
    return CaseData(_stack_nhwc(u, v, mask), params)


def _pad_tube_like(u, v, mask, left_u_value):
    """Left column = BC, then top+bottom rows = 0 (tube/dam padding).

    ``left_u_value``: scalar (tube: vel_in) or per-(T,H) array (dam:
    velocity below the barrier top only) — numpy broadcasting handles
    both."""
    u = np.pad(u, ((0, 0), (0, 0), (1, 0)), constant_values=0)
    u[:, :, 0] = left_u_value
    v = np.pad(v, ((0, 0), (0, 0), (1, 0)), constant_values=0)
    mask = np.pad(mask, ((0, 0), (0, 0), (1, 0)), constant_values=0)
    u = np.pad(u, ((0, 0), (1, 1), (0, 0)), constant_values=0)
    v = np.pad(v, ((0, 0), (1, 1), (0, 0)), constant_values=0)
    mask = np.pad(mask, ((0, 0), (1, 1), (0, 0)), constant_values=0)
    return u, v, mask


def load_case_tube(case_dir: Path) -> CaseData:
    params = load_json(case_dir / "case.json")
    u = load_npy(case_dir / "u.npy")
    v = load_npy(case_dir / "v.npy")
    mask = np.ones_like(u)
    u, v, mask = _pad_tube_like(u, v, mask, params["vel_in"])
    return CaseData(_stack_nhwc(u, v, mask), params)


def load_case_dam(case_dir: Path, fix_barrier_mask: bool = False) -> CaseData:
    params = load_json(case_dir / "case.json")
    u = load_npy(case_dir / "u.npy")
    v = load_npy(case_dir / "v.npy")
    mask = np.ones_like(u)

    barrier_left = 0.5
    barrier_right = barrier_left + params["barrier_width"]
    barrier_left_idx = int(barrier_left / params["dx"])
    barrier_right_idx = int(barrier_right / params["dx"])
    barrier_top_idx = int(params["barrier_height"] / params["dy"])
    if fix_barrier_mask:
        # Intended behavior: zero the barrier rectangle (rows below the
        # barrier top). The reference's slice (src/dataset/dam.py:82-84)
        # indexes the time axis with start=0 and is a no-op (defect #3).
        mask[:, :barrier_top_idx, barrier_left_idx:barrier_right_idx] = 0

    # Left BC column: velocity below barrier top only (dam.py:87-93).
    T, H, W = u.shape
    left_col = np.zeros((T, H), dtype=u.dtype)
    left_col[:, :barrier_top_idx] = params["velocity"]
    u, v, mask = _pad_tube_like(u, v, mask, left_col)

    # Params filtered to 5 keys (dam.py:108-109).
    keep = ["velocity", "density", "viscosity", "height", "width"]
    params = {k: params[k] for k in keep}
    return CaseData(_stack_nhwc(u, v, mask), params)


def load_case_cylinder(case_dir: Path) -> CaseData:
    """Active cylinder loader (``load_case_data_fix``, cylinder.py:194-282)."""
    params = load_json(case_dir / "case.json")
    u = load_npy(case_dir / "u.npy")
    v = load_npy(case_dir / "v.npy")

    x_min, x_max = params["x_min"], params["x_max"]
    y_min, y_max = params["y_min"], params["y_max"]
    radius = params["radius"]
    center_x = params.get("center_x", 0.0)
    center_y = params.get("center_y", 0.0)
    params["center_x"] = center_x
    params["center_y"] = center_y
    params["height"] = y_max - y_min
    params["width"] = x_max - x_min
    for key in ("x_min", "x_max", "y_min", "y_max"):
        params.pop(key, None)

    T, H, W = u.shape
    dx = params["width"] / W
    dy = params["height"] / H
    # Physical coordinates of cell centers (vectorized; the reference
    # loops per pixel — cylinder.py:249-262 — with identical result).
    xs = x_min + (np.arange(W) + 0.5) * dx
    ys = y_min + (np.arange(H) + 0.5) * dy
    dist_sq = (xs[None, :] - center_x) ** 2 + (ys[:, None] - center_y) ** 2
    mask2d = (dist_sq > radius**2).astype(u.dtype)
    mask2d[0, :] = 0
    mask2d[-1, :] = 0
    mask2d[:, 0] = 0
    mask = np.broadcast_to(mask2d, u.shape).copy()
    return CaseData(_stack_nhwc(u, v, mask), params)


_LOADERS = {
    "cavity": load_case_cavity,
    "tube": load_case_tube,
    "dam": load_case_dam,
    "cylinder": load_case_cylinder,
}


def load_case(problem: str, case_dir: Path, **kwargs) -> CaseData:
    case = _LOADERS[problem](case_dir, **kwargs)
    if case.params.get("__normalized__"):
        raise ValueError("case params already normalized")
    return case


def normalize_case_params(problem: str, params: dict, norm_props: bool,
                          norm_bc: bool) -> None:
    # Normalization mutates in place and datasets alias these dicts —
    # the flag makes a second pass (silent double z-scoring) an error
    # (checked in load_case and here).
    if params.get("__normalized__"):
        raise ValueError("case params already normalized")
    if norm_props:
        normalize_physics_props(params)
    if norm_bc:
        normalize_bc(params, BC_KEY[problem])
    if norm_props or norm_bc:
        params["__normalized__"] = True


def collect_case_dirs(problem_dir: Path, subsets: str) -> List[Path]:
    """Glob case dirs across requested subsets, in reference order.

    Mirrors e.g. ``get_cavity_auto_datasets`` (cavity.py:407-415): for
    each of prop/bc/geo *present in* ``subsets``, glob ``case*`` sorted
    numerically by the suffix.
    """
    case_dirs: List[Path] = []
    for name in ["prop", "bc", "geo"]:
        if name in subsets:
            sub = problem_dir / name
            case_dirs += sorted(
                sub.glob("case*"), key=lambda x: int(x.name[4:])
            )
    if not case_dirs:
        raise FileNotFoundError(
            f"no cases found under {problem_dir} for '{subsets}'"
        )
    return case_dirs


def split_cases(
    case_dirs: Sequence[Path], seed: int = 0
) -> Tuple[List[Path], List[Path], List[Path]]:
    """Seed-``seed`` shuffle + 80/10/10 case-level split.

    Uses python's ``random`` module so the ordering is bit-identical to
    the reference (cavity.py:419-428).
    """
    dirs = list(case_dirs)
    random.seed(seed)
    random.shuffle(dirs)
    n = len(dirs)
    n_train = round(n * 0.8)
    n_dev = round(n * 0.1)
    return (
        dirs[:n_train],
        dirs[n_train: n_train + n_dev],
        dirs[n_train + n_dev:],
    )
