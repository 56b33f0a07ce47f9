"""Host-side batch pipeline (port of ``cfdbench_tpu/data/pipeline.py``).

Datasets are packed host numpy arrays; each epoch is an index
permutation sliced into batches of one shape: the last, partial batch is
padded with zeros and carries 0/1 sample weights, so the metrics stay
exact (``metrics.py``). The shuffle follows the JAX package's bit for
bit: the same ``numpy`` generator gives the same batches.
:func:`to_device` moves a batch to the device through pinned memory
without making the host wait: the counterpart of the JAX package's
``device_prefetch``, whose queue of ``device_put``s a non-blocking copy
makes unneeded (the host queues the next batch while the device still
works on the last step).
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
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield dicts of batched arrays plus a (batch,) ``weights`` array of
    0/1."""
    n = next(iter(arrays.values())).shape[0]
    for a in arrays.values():
        if a.shape[0] != n:
            raise ValueError(f"arrays of {a.shape[0]} and {n} rows in one dataset")
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    for start in range(0, n, batch_size):
        take = idx[start: start + batch_size]
        batch = {k: _pad_to(a[take], batch_size) for k, a in arrays.items()}
        w = np.zeros((batch_size,), dtype=np.float32)
        w[: take.size] = 1.0
        batch["weights"] = w
        yield batch


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
