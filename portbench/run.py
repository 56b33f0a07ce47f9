"""Run one cell of the root ``BENCHMARK.json`` on this machine's card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``harness.py``); it is not
printed when there is no CUDA card, fewer cards than the cell asks for, or a
JAX module loaded. Builds and kernel caches stay under ``build/`` in the
checkout.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().replace("\n", "; ") or f"not read ({out.stderr.strip()})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.find_cell(harness.load_manifest(), a.workload)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card and power limit: {power_limit()}", flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        result = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), device)
    except harness.ForbiddenModules as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
