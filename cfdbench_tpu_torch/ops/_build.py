"""Build the CUDA kernels in ``cfdbench_tpu_torch/csrc`` and bind them.

The ``.cu`` files have a plain C interface, so ``nvcc`` alone turns
them into one shared library in seconds and ``ctypes`` loads it; no
PyTorch headers are compiled. The library goes to
``build/cfdbench_tpu_torch/`` beside the package (listed in
``.gitignore``) and is rebuilt when any source, or this file with its
compiler flags, is newer than it. The compiler's ``-Xptxas -v``
report (registers, shared memory, spills per kernel) is kept in
``nvcc.log`` next to it.

Nothing here runs at import: the first kernel launch builds and loads.

:func:`load_emulation` builds the same sources with the host's C++
compiler and ``-DFNO_EMULATE`` (``csrc/emulate/emu.h``) into a library
with the same entry points that runs the kernels on the CPU, thread by
thread: slow, for checking their indexing at tiny shapes without a card.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cfdbench_tpu_torch"
LIBRARY = BUILD_DIR / "libcfdbench_fno.so"
EMULATION = BUILD_DIR / "libcfdbench_fno_emulated.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
EMULATION_FLAGS = (
    "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
    "-DFNO_EMULATE", "-Wno-unknown-pragmas",
)


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels are built from source"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("**/*.cuh")) + sorted(CSRC.glob("**/*.h"))


def _build(target: Path, compiler: str, flags, log_name: str) -> Path:
    """Compile ``csrc/*.cu`` into ``target`` unless it is newer than
    every source and than this file, which holds the flags. Raises with
    the compiler's output on failure."""
    cu, headers = _sources()
    if target.exists() and target.stat().st_mtime >= max(
        p.stat().st_mtime for p in [*cu, *headers, Path(__file__)]
    ):
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / log_name).write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{compiler} failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def build_library() -> Path:
    """The kernels for the card, built by ``nvcc`` into :data:`LIBRARY`."""
    return _build(LIBRARY, find_nvcc(), NVCC_FLAGS, "nvcc.log")


def find_host_compiler() -> str:
    for name in ("g++", "clang++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or clang++) for the kernels' emulation")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every entry
    point's argument types."""
    return _declare(ctypes.CDLL(str(build_library())))


@functools.lru_cache(maxsize=None)
def load_emulation() -> ctypes.CDLL:
    """The kernels' CPU emulation (see the module docstring): the same
    entry points, taking host pointers."""
    return _declare(ctypes.CDLL(str(
        _build(EMULATION, find_host_compiler(), EMULATION_FLAGS, "emulation.log"))))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Every entry point's argument types (pointers and the stream as
    ``c_void_p``)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fno_block_forward.argtypes = [ptr] * 13 + [i32] * 9 + [ptr]
    lib.fno_block_forward.restype = i32
    lib.fno_head_forward.argtypes = [ptr] * 7 + [i64, i32, i32, i32, ptr]
    lib.fno_head_forward.restype = i32
    lib.fno_error_string.argtypes = [i32]
    lib.fno_error_string.restype = ctypes.c_char_p
    lib.fno_block_tiles.argtypes = [ctypes.POINTER(i32)]
    lib.fno_block_tiles.restype = None
    lib.fno_block_unsupported.argtypes = [i32] * 3
    lib.fno_block_unsupported.restype = ctypes.c_char_p
    lib.fno_head_unsupported.argtypes = [i32] * 3
    lib.fno_head_unsupported.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.fno_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
