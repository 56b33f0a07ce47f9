"""Prefetching file reads for the data layer (the port's own copy of
``cfdbench_tpu/data/fast_io.py``).

:func:`prefetch_npy` reads a batch of ``.npy`` files through the native
C++ thread pool (``cfdbench_tpu_torch/native``) into a cache in memory;
:func:`load_npy` then serves each file from the cache, consuming its
entry (one use a prefetch: the memory is handed over, not kept), or reads
it with ``np.load``. A split then loads in parallel batches instead of
the reference's serial ``np.load`` a file (``src/dataset/cavity.py:15-34``).

The library builds at first use and a build that fails raises: there is
no silent ``np.load`` for a reader that did not build. A batch that holds
a file the reader does not take (a dtype other than ``<f4``/``<f8``, or
Fortran order: ``native.UnsupportedNpy``) is left to ``np.load``, as the
JAX package's is. Either way every array is float32, equal bit for bit
to ``np.load(path).astype(np.float32)`` (``tests/test_torch_native.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from .. import native

_CACHE: Dict[str, np.ndarray] = {}


def prefetch_npy(paths: Sequence, n_threads: int = 16) -> int:
    """Read ``paths`` (those that exist and are not cached) into the cache
    in one native batch; returns how many were read, 0 for a batch that
    holds a file the reader does not take."""
    todo = [str(p) for p in paths if Path(p).exists()]
    todo = [p for p in todo if p not in _CACHE]
    if not todo:
        return 0
    try:
        arrays = native.read_npy_f32_batch(todo, n_threads=n_threads)
    except native.UnsupportedNpy:
        return 0
    _CACHE.update(zip(todo, arrays))
    return len(todo)


def prefetch_case_uv(case_dirs: Sequence) -> int:
    """Prefetch every case's ``u.npy`` and ``v.npy`` in one batch."""
    return prefetch_npy([Path(d) / name for d in case_dirs for name in ("u.npy", "v.npy")])


def load_npy(path) -> np.ndarray:
    """``np.load`` as float32, from the cache where the file was prefetched
    (the entry is consumed)."""
    arr = _CACHE.pop(str(path), None)
    if arr is not None:
        return arr
    return np.load(path).astype(np.float32, copy=False)


def clear_cache() -> None:
    _CACHE.clear()
