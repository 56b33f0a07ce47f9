"""The data layer's native (C++) ``.npy`` reader: the port's own copy of
``cfdbench_tpu/native``.

``npy_reader.cc`` reads a batch of case files into float32 arrays with a
thread pool, where ``np.load`` in a Python loop reads one file at a time:
at the real dataset's scale (about 13 GB over thousands of case
directories) that loop is the cold start of every run. The host's C++
compiler (``$CXX``, else ``g++`` or ``clang++``) builds it at first use
into ``build/cfdbench_tpu_torch/`` through ``ops/_build.py``, rebuilt
when the source or the build's flags change; a build that fails raises
with the compiler's output. The binding is ctypes:

- :func:`available` — whether the library builds and loads (for
  reports; the readers raise instead);
- :func:`npy_shape` — a file's shape, from its header;
- :func:`read_npy_f32` — one file as a float32 array;
- :func:`read_npy_f32_batch` — many files, read in parallel.

The reader takes what the dataset holds: npy format 1.0-3.0, ``<f4`` or
``<f8``, C order. Another dtype or Fortran order raises
:class:`UnsupportedNpy`, on which ``data/fast_io.py`` reads the batch with
``np.load``; any other fault (a missing or truncated file, a corrupt
header) raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

from ..ops import _build

SOURCE = Path(__file__).resolve().with_name("npy_reader.cc")
LIBRARY = _build.BUILD_DIR / "libcfdbench_npy.so"
FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")

# The reader's error codes (npy_reader.cc); 4 and 5 are the format rule.
ERRORS = {
    1: "cannot open file",
    2: "bad npy magic",
    3: "unsupported/corrupt npy header",
    4: "unsupported dtype (only <f4/<f8)",
    5: "fortran-order arrays unsupported",
    6: "file shorter than header claims",
    7: "element count mismatch",
}
UNSUPPORTED = (4, 5)

_lock = threading.Lock()
_lib = None


class UnsupportedNpy(ValueError):
    """A file the reader does not take: a dtype other than ``<f4``/``<f8``,
    or Fortran order."""


def _compiler() -> str:
    return os.environ.get("CXX") or _build.find_host_compiler()


def load() -> ctypes.CDLL:
    """Build if needed and load once per process (thread-safe); raises
    with the compiler's output when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = _build.build(LIBRARY, _compiler(), FLAGS, "npy_reader.log", [SOURCE])
            lib = ctypes.CDLL(str(path))
            ptr_f32 = ctypes.POINTER(ctypes.c_float)
            lib.cfd_npy_header.restype = ctypes.c_int
            lib.cfd_npy_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]
            lib.cfd_npy_read_f32.restype = ctypes.c_int
            lib.cfd_npy_read_f32.argtypes = [ctypes.c_char_p, ptr_f32, ctypes.c_int64]
            lib.cfd_npy_read_f32_batch.restype = ctypes.c_int
            lib.cfd_npy_read_f32_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ptr_f32),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_int]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _raise(path, rc: int) -> None:
    if rc:
        kind = UnsupportedNpy if rc in UNSUPPORTED else ValueError
        raise kind(f"{path}: {ERRORS.get(rc, rc)}")


def npy_shape(path) -> tuple:
    """The shape in a file's header."""
    shape = (ctypes.c_int64 * 8)()
    ndim, dsize = ctypes.c_int(), ctypes.c_int()
    _raise(path, load().cfd_npy_header(str(path).encode(), shape, ctypes.byref(ndim),
                                       ctypes.byref(dsize)))
    return tuple(shape[i] for i in range(ndim.value))


def read_npy_f32(path) -> np.ndarray:
    """One file as a float32 array (``<f8`` converted as it is read)."""
    out = np.empty(npy_shape(path), np.float32)
    _raise(path, load().cfd_npy_read_f32(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size))
    return out


def read_npy_f32_batch(paths: Sequence, n_threads: int = 16) -> List[np.ndarray]:
    """Many files as float32 arrays, read by a pool of at most
    ``n_threads`` threads, capped at the CPUs this process may use (more
    threads than cores cost more than they buy on a small host). Raises on
    the first failing file in ``paths``' order."""
    if not paths:
        return []
    lib = load()
    n = len(paths)
    n_threads = max(1, min(n_threads, len(os.sched_getaffinity(0))))
    outs = [np.empty(npy_shape(p), np.float32) for p in paths]
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for o in outs])
    c_ns = (ctypes.c_int64 * n)(*[o.size for o in outs])
    c_rcs = (ctypes.c_int * n)()
    if lib.cfd_npy_read_f32_batch(c_paths, c_outs, c_ns, c_rcs, n, n_threads):
        for p, rc in zip(paths, c_rcs):
            _raise(p, rc)
    return outs
