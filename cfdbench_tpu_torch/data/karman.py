"""Legacy Kármán-vortex dataset (mirror of ``src/dataset/base.py:10-87``;
the port's own copy of ``cfdbench_tpu/data/karman.py``).

A single-directory dataset of ``u.npy``/``v.npy``/``mask.npy`` with
BC padding: fields padded 1 on top/bottom/left; mask flipped
(reference stores boundaries=1) and padded; u's left/right interior
columns set to 0.5. Pairs are offset by ``time_step_size`` frames.
Kept for inventory parity; the cylinder problem supersedes it.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


def load_karman_data(data_dir: Path):
    u = np.load(Path(data_dir) / "u.npy")
    v = np.load(Path(data_dir) / "v.npy")
    mask = np.load(Path(data_dir) / "mask.npy")
    u = np.pad(u, ((0, 0), (1, 1), (1, 0)), constant_values=0)
    v = np.pad(v, ((0, 0), (1, 1), (1, 0)), constant_values=0)
    mask = 1 - np.pad(mask, ((1, 1), (1, 0)), constant_values=1)
    u[:, 1:-1, 0] = 0.5
    u[:, 1:-1, -1] = 0.5
    return u, v, mask


@dataclass
class KarmanDataset:
    features: np.ndarray  # (N, H, W, 2) inputs
    labels: np.ndarray    # (N, H, W, 2)
    mask: np.ndarray      # (H, W)

    def __len__(self):
        return self.features.shape[0]


def build_karman_dataset(data_dir: Path, time_step_size: int = 10
                         ) -> KarmanDataset:
    u, v, mask = load_karman_data(data_dir)
    fields = np.stack([u, v], axis=-1).astype(np.float32)  # (T, H, W, 2)
    return KarmanDataset(
        features=fields[:-time_step_size],
        labels=fields[time_step_size:],
        mask=mask.astype(np.float32),
    )
