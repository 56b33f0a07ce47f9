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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into :data:`LIBRARY` unless it is newer
    than every source and than this file, which holds the flags. Raises
    with the compiler's output on failure."""
    cu, cuh = _sources()
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= max(
        p.stat().st_mtime for p in [*cu, *cuh, Path(__file__)]
    ):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every entry
    point's argument types (pointers and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fno_block_forward.argtypes = [ptr] * 11 + [i32] * 9 + [ptr]
    lib.fno_block_forward.restype = i32
    lib.fno_head_forward.argtypes = [ptr] * 7 + [i64, i32, i32, i32, ptr]
    lib.fno_head_forward.restype = i32
    lib.fno_error_string.argtypes = [i32]
    lib.fno_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.fno_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
