"""``--profile_dir``: a ``torch.profiler`` trace of an entry point.

The JAX package starts ``jax.profiler.start_trace(profile_dir)`` when an
entry point applies its runtime flags and stops it at the process's exit
(``cfdbench_tpu/cli.py:57-61``), one trace a process. Here
:func:`profile_trace` wraps the entry point's run: the trace starts where
the JAX one starts, after the flags are checked, and is written when the
entry point returns or raises, so a process that calls an entry point twice
writes two traces. Each rank writes its own Chrome-trace file into the
directory, ``rank<r>.<n>.pt.trace.json``, ``n`` the first index that this
rank has not written there yet; ``chrome://tracing`` or Perfetto open it.
On the card the trace holds the CPU's operators and the CUDA kernels (the
FNO's by their kernel names); on the CPU the operators alone.

On an H100 machine (torch 2.11, CUDA 12.8) every profiler session but a
young process's lost the records of its first CUDA kernels: one more for
about every 13 s the process had run (none in its first 30 s, 18 at 250
s), the same in four processes started together, and
the same whether the session waited up to 0.1 s or synchronised before
its first kernel. The kernels ran; only their records were missing. So
a session on a CUDA device opens with a warm-up of tiny kernels that
takes that loss (:func:`warm_up`), sized far above what was seen.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
from pathlib import Path
from typing import Iterator

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

# The warm-up's kernels: WARMUP_KERNELS, and WARMUP_PER_SECOND more for each
# second of the process's age (6x the loss seen a second).
WARMUP_KERNELS = 64
WARMUP_PER_SECOND = 0.5


def trace_path(profile_dir: Path, rank: int) -> Path:
    """The next trace file of ``rank`` in ``profile_dir``."""
    for n in itertools.count():
        path = profile_dir / f"rank{rank}.{n}.pt.trace.json"
        if not path.exists():
            return path


def process_age() -> float:
    """Seconds since this process started (from Linux's ``/proc``), or an
    hour where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 3600.0


def warmup_kernels() -> int:
    """How many kernels :func:`warm_up` launches at this process's age."""
    return WARMUP_KERNELS + math.ceil(WARMUP_PER_SECOND * process_age())


def warm_up(device: torch.device) -> None:
    """Launch the kernels whose records an opening session on ``device``
    may lose (one-element adds, under the trace's ``profile_trace
    warm-up`` range) and wait for them."""
    x = torch.zeros(1, device=device)
    with record_function("profile_trace warm-up"):
        for _ in range(warmup_kernels()):
            x.add_(1)
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_trace(profile_dir: str, device: torch.device) -> Iterator[None]:
    """Profile the body into a new trace file of this process's rank under
    ``profile_dir``, CPU and CUDA activity on a CUDA ``device`` (after
    :func:`warm_up`), CPU activity alone on the CPU; nothing when
    ``profile_dir`` is empty. The file is written when the body ends,
    normally or by an exception."""
    if not profile_dir:
        yield
        return
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = trace_path(Path(profile_dir), rank)
    prof = profile(activities=activities)
    prof.start()
    try:
        if device.type == "cuda":
            warm_up(device)
        yield
    finally:
        prof.stop()
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        print(f"[profile] trace written to {path}")
