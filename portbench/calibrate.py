"""The readings that a cell's limits are set from, on this machine's card:
the program's on many seeds, and the control's and each fault's
(``variants.py``) on a few, each one run of the cell (set-up, a short window,
the comparison), all in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --variants program tf32 half_batch --seeds 1 2 3 ...

Prints one JSON line a run: the variant, the seed, every number compared,
``correct`` under the cell's present limits, and the end-to-end metrics.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variants", nargs="+", default=["program"])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, variants

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_manifest(), a.workload)
    device = torch.device("cuda", 0)
    for variant in a.variants:
        plant = None if variant == "program" else variants.VARIANTS[variant]
        for seed in a.seeds:
            r = harness.run_cell(cell, seed, a.seconds, False, device, plant=plant)
            print(json.dumps(dict(
                workload=a.workload, variant=variant, seed=seed, correct=r["correct"],
                readings={k: c["value"] for k, c in r["checks"].items()},
                metrics={k: m["value"] for k, m in r["metrics"].items()},
                attempted=r["attempted"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
