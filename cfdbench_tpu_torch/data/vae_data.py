"""The VAE's training frames (port of ``cfdbench_tpu/data/vae_data.py``,
the reference's ``src/dataset/vae.py``).

The label frames' 2 velocity channels, resized to 64x64 and normalised
with the reference's fixed statistics (``vae.py:25-33``). The resize is
``jax.image.resize(…, "bilinear")``'s, written in numpy: separable
triangle-kernel weights (``jax/_src/image/scale.py``,
``compute_weight_mat``) that widen the kernel when shrinking (its
``antialias=True`` default, so tube's and dam's 66x65 fields are
low-pass filtered on their way to 64x64). ``F.interpolate``'s antialias
follows PIL's instead, and is not used.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .datasets import AutoDataset

VAE_MEAN = np.asarray([1.891, 1.806], np.float32)
VAE_STD = np.asarray([1.550, 1.574], np.float32)
VAE_SIZE = 64


@dataclass
class VaeDataset:
    frames: np.ndarray  # (N, size, size, 2)

    def __len__(self):
        return self.frames.shape[0]


def resize_weights(input_size: int, output_size: int) -> np.ndarray:
    """``(input_size, output_size)``: JAX's bilinear weights with antialias,
    zero scale translation: the triangle kernel, widened by the shrink
    factor, at the output's half-pixel centres, each column normalised to
    sum 1."""
    inv_scale = input_size / output_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(output_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(input_size)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= input_size - 0.5)
    return np.where(inside[None, :], weights, 0.0)


def resize_bilinear(frames: np.ndarray, size) -> np.ndarray:
    """``jax.image.resize(frames, (N, *size, C), "bilinear")`` for NHWC
    ``frames``: float32 out, summed in float64."""
    out = np.asarray(frames, np.float64)
    for axis, n in ((1, size[0]), (2, size[1])):
        if out.shape[axis] != n:
            w = resize_weights(out.shape[axis], n)
            out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out.astype(np.float32)


def build_vae_dataset(base: AutoDataset) -> VaeDataset:
    frames = base.labels  # (N, H, W, 2)
    if frames.shape[1:3] != (VAE_SIZE, VAE_SIZE):
        frames = resize_bilinear(frames, (VAE_SIZE, VAE_SIZE))
    return VaeDataset(frames=((frames - VAE_MEAN) / VAE_STD).astype(np.float32))
