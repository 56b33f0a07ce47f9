"""Host-side batch pipeline (port of ``cfdbench_tpu/data/pipeline.py``).

Datasets are packed host numpy arrays; each epoch is an index
permutation sliced into batches of one shape: the last, partial batch is
padded with zeros and carries 0/1 sample weights, so the metrics stay
exact (``metrics.py``); under data parallelism every batch is padded up
to a multiple of the rank count (``pad_multiple``), and each rank takes
its block of it (``parallel/mesh.py``). The shuffle follows the JAX
package's bit for bit: the same ``numpy`` generator gives the same
batches.
:func:`to_device` moves a batch to the device through pinned memory
without making the host wait: the counterpart of the JAX package's
``device_prefetch``, whose queue of ``device_put``s a non-blocking copy
makes unneeded (the host queues the next batch while the device still
works on the last step). Under spatial sharding each rank then takes its
grid rows of every field (:func:`field_rows`).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = np.zeros((n - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def batches(
    arrays: Dict[str, np.ndarray],
    batch_size: int,
    shuffle: bool,
    rng: Optional[np.random.Generator] = None,
    pad_multiple: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield dicts of batched arrays plus a (batch,) ``weights`` array of
    0/1. ``pad_multiple`` rounds the padded batch up to a multiple of it,
    the data-parallel rank count."""
    n = next(iter(arrays.values())).shape[0]
    for a in arrays.values():
        if a.shape[0] != n:
            raise ValueError(f"arrays of {a.shape[0]} and {n} rows in one dataset")
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    target = -(-batch_size // pad_multiple) * pad_multiple
    for start in range(0, n, batch_size):
        take = idx[start: start + batch_size]
        batch = {k: _pad_to(a[take], target) for k, a in arrays.items()}
        w = np.zeros((target,), dtype=np.float32)
        w[: take.size] = 1.0
        batch["weights"] = w
        yield batch


def field_rows(batch: Dict[str, np.ndarray], axis) -> Dict[str, np.ndarray]:
    """This model rank's grid rows of every (B, H, W, C) leaf of a batch
    (``inputs``, ``labels``, ``mask``), as the JAX package's
    ``batch_sharding_spatial`` places them over ``axis`` (a
    ``parallel.mesh.ModelAxis``); ``case_params`` and ``weights`` stay
    whole. Rows are never padded: H must divide by the axis's size. The
    batch itself without an axis of more than one rank."""
    if axis is None or not axis.distributed:
        return batch
    out = {}
    for k, a in batch.items():
        if a.ndim == 4:
            if a.shape[1] % axis.size:
                raise ValueError(f"{k}: {a.shape[1]} rows do not split over {axis.size} ranks")
            h = a.shape[1] // axis.size
            a = a[:, axis.rank * h: (axis.rank + 1) * h]
        out[k] = a
    return out


def num_batches(n: int, batch_size: int) -> int:
    return -(-n // batch_size)


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch as float32 tensors on ``device``: on a CUDA device one
    non-blocking copy per array from pinned memory; on the CPU the arrays
    themselves, without a copy where they are float32 already."""
    device = torch.device(device)
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
