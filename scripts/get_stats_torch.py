#!/usr/bin/env python
"""Per-channel mean/std of a dataset's frames in the VAE's input space
(mirror of ``scripts/utils/get_stats.py:17-33``; the port's counterpart of
``scripts/get_stats.py``) — the source of the hardcoded ``VaeDataset``
normalization constants.

Like the reference (which builds an identity-normalized ``VaeDataset``
and iterates it), stats are computed AFTER the 64x64 bilinear resize
that the VAE pipeline applies — on non-64x64 problems (tube/dam are
66x65) raw-frame stats would differ from what the VAE actually sees. The
resize is the port's numpy copy of ``jax.image.resize``
(``cfdbench_tpu_torch/data/vae_data.py::resize_bilinear``).

Usage: python scripts/get_stats_torch.py --data_name cavity_prop_bc_geo \
    --data_dir <root>
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402

from cfdbench_tpu_torch.config import Args  # noqa: E402
from cfdbench_tpu_torch.data import get_auto_dataset  # noqa: E402
from cfdbench_tpu_torch.data.vae_data import build_vae_dataset  # noqa: E402


def frame_stats(args: Args):
    """``(frames, mean, std)``: the train split's frame count and per-channel
    mean and standard deviation in the VAE's input space, summed in
    float64. The JAX script sums float32, which numpy does over the frame
    axes one element at a time and which strays by some 1e-5 of the mean
    over a dataset's frames; so its printed figures may differ from these
    by one unit of their fourth decimal."""
    train, _, _ = get_auto_dataset(
        data_dir=Path(args.data_dir),
        data_name=args.data_name,
        delta_time=args.delta_time,
        norm_props=bool(args.norm_props),
        norm_bc=bool(args.norm_bc),
        load_splits=["train"],
        seed=args.seed,
        cache_dir=args.cache_dir or None,
    )
    # Identity-normalized VAE frame space: post-resize, pre-normalize.
    labels = build_vae_dataset(train, normalize=False).frames.astype(np.float64)
    return labels.shape[0], labels.mean(axis=(0, 1, 2)), labels.std(axis=(0, 1, 2))


def main(argv=None):
    args = Args.parse_args(argv)
    n, mean, std = frame_stats(args)
    print(f"dataset: {args.data_name}")
    print(f"# frames: {n}")
    print(f"channel mean (u, v): {np.round(mean, 4).tolist()}")
    print(f"channel std  (u, v): {np.round(std, 4).tolist()}")


if __name__ == "__main__":
    main()
