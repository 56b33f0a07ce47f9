#!/usr/bin/env python
"""Validate a real CFDBench case tree before first training contact (the
port's counterpart of ``scripts/check_dataset.py``, importing only
``cfdbench_tpu_torch``).

A migrating user's first contact is: download the ~13 GB dataset → point
``--data_dir`` at it → train. This script checks the tree *before* a
trainer spends minutes loading it, and reports what a run will see:

- layout: ``<root>/<problem>/<subset>/case*/{u.npy,v.npy,case.json}``
  (reference ``README.md:59-87``; subsets prop/bc/geo)
- per-case integrity on a sample: u/v are 3-D ``(T, H, W)`` float
  arrays of identical shape, finite (no NaN/Inf), T >= 2 (an
  autoregressive pair needs two frames)
- ``case.json`` carries every key the problem's loader + normalization
  consume (``cfdbench_tpu_torch/data/core.py::REQUIRED_CASE_KEYS``; dam
  additionally needs the barrier/grid keys its mask math reads,
  dam.py:51-110)
- per-problem/subset case counts and the 80/10/10 split sizes, computed
  by the port's own splitter (``data/core.py::split_cases``)
- an estimated cache-build (full tree read) time, measured from the
  sampled files with ``np.load`` and with the port's native C++ reader
  (``cfdbench_tpu_torch/native``, which the loaders read through), as the
  JAX script measures its own: ``read_mb_s_native`` and
  ``est_full_read_s_native``, or ``note_native`` where the reader does not
  build here

The report has every key of the JAX script's.

Exit code 0 = usable (warnings allowed), 1 = at least one error.
``--json`` prints a machine-readable report instead of text.

Usage:
    python scripts/check_dataset_torch.py /path/to/data [--problems tube,dam]
        [--sample 8] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from cfdbench_tpu_torch import native  # noqa: E402
from cfdbench_tpu_torch.data import fast_io  # noqa: E402
from cfdbench_tpu_torch.data.core import (  # noqa: E402
    PROBLEMS,
    REQUIRED_CASE_KEYS,
    split_cases,
)

SUBSETS = ("prop", "bc", "geo")
# Keys the conditioning vector additionally expects (params_to_vector
# keeps them; the paper's 5-param problems include height/width).
EXPECTED_KEYS = {
    "cavity": {"height", "width"},
    "tube": {"height", "width"},
    "dam": set(),
    "cylinder": {"center_x", "center_y"},
}


def _check_case(problem: str, case_dir: Path, report: dict) -> int:
    """Deep-check one case; returns the case's u+v byte size."""
    errors = report["errors"]
    rel = str(case_dir)
    size = 0
    arrays = {}
    for name in ("u.npy", "v.npy"):
        p = case_dir / name
        if not p.exists():
            errors.append(f"{rel}: missing {name}")
            continue
        size += p.stat().st_size
        try:
            arrays[name] = np.load(p)
        except Exception as e:  # corrupt download / truncated file
            errors.append(f"{rel}/{name}: unreadable ({e})")
    p = case_dir / "case.json"
    params = None
    if not p.exists():
        errors.append(f"{rel}: missing case.json")
    else:
        try:
            params = json.loads(p.read_text())
        except Exception as e:
            errors.append(f"{rel}/case.json: invalid JSON ({e})")

    for name, a in arrays.items():
        if a.ndim != 3:
            errors.append(f"{rel}/{name}: expected (T,H,W), got {a.shape}")
        elif a.shape[0] < 2:
            errors.append(
                f"{rel}/{name}: T={a.shape[0]} < 2 — no autoregressive "
                "pair possible"
            )
        if not np.issubdtype(a.dtype, np.floating):
            errors.append(f"{rel}/{name}: non-float dtype {a.dtype}")
        elif not np.isfinite(a).all():
            errors.append(f"{rel}/{name}: contains NaN/Inf")
    if len(arrays) == 2 and arrays["u.npy"].shape != arrays["v.npy"].shape:
        errors.append(
            f"{rel}: u {arrays['u.npy'].shape} != v "
            f"{arrays['v.npy'].shape}"
        )
    if "u.npy" in arrays and arrays["u.npy"].ndim == 3:
        report["shapes"].add(arrays["u.npy"].shape[1:])
        report["frames"] += arrays["u.npy"].shape[0]

    if isinstance(params, dict):
        missing = REQUIRED_CASE_KEYS[problem] - params.keys()
        if missing:
            errors.append(
                f"{rel}/case.json: missing required keys {sorted(missing)}"
            )
        expected = EXPECTED_KEYS[problem] - params.keys()
        if expected:
            report["warnings"].append(
                f"{rel}/case.json: missing optional keys "
                f"{sorted(expected)} (conditioning vector will be shorter)"
            )
        bad = [
            k for k, v in params.items()
            if not isinstance(v, (int, float, bool))
        ]
        if bad:
            report["warnings"].append(
                f"{rel}/case.json: non-scalar values for {bad}"
            )
    return size


def _estimate_cache_build(sample_files, total_bytes, report):
    """Measure the read throughput of ``np.load`` and then of the native
    reader (one parallel batch) on the sampled files, and project each to
    the whole tree."""
    sample_bytes = sum(p.stat().st_size for p in sample_files)
    if not sample_bytes:
        return
    t0 = time.perf_counter()
    for p in sample_files:
        np.load(p)
    dt = max(time.perf_counter() - t0, 1e-9)
    py_bps = sample_bytes / dt
    report["read_mb_s_numpy"] = round(py_bps / 1e6, 1)
    report["est_full_read_s_numpy"] = round(total_bytes / py_bps, 1)
    if native.available():
        fast_io.clear_cache()
        t0 = time.perf_counter()
        fast_io.prefetch_npy(sample_files)
        dt = max(time.perf_counter() - t0, 1e-9)
        fast_io.clear_cache()
        nat_bps = sample_bytes / dt
        report["read_mb_s_native"] = round(nat_bps / 1e6, 1)
        report["est_full_read_s_native"] = round(total_bytes / nat_bps, 1)
    else:
        report["read_mb_s_native"] = None
        report["note_native"] = (
            "native reader did not build (cfdbench_tpu_torch/native); the port's "
            "loaders raise until it does"
        )


def check_problem(root: Path, problem: str, sample: int) -> dict:
    report = _check_problem(root, problem, sample)
    # Every exit path (incl. missing-dir early returns) must leave the
    # report JSON-serializable: shapes is a set during collection.
    report["shapes"] = sorted(str(s) for s in report["shapes"])
    return report


def _check_problem(root: Path, problem: str, sample: int) -> dict:
    report = dict(
        problem=problem, subsets={}, errors=[], warnings=[],
        shapes=set(), frames=0, total_bytes=0, cases_total=0,
    )
    pdir = root / problem
    if not pdir.is_dir():
        report["errors"].append(f"{pdir}: problem directory missing")
        return report

    all_cases = []
    for subset in SUBSETS:
        sdir = pdir / subset
        if not sdir.is_dir():
            report["warnings"].append(f"{sdir}: subset missing")
            continue
        cases = sorted(sdir.glob("case*"), key=lambda x: x.name)
        non_numeric = [c.name for c in cases if not c.name[4:].isdigit()]
        if non_numeric:
            report["errors"].append(
                f"{sdir}: case dirs with non-numeric suffix "
                f"{non_numeric[:3]} — the loaders sort by int(name[4:]) "
                "(dataset/tube.py:312)"
            )
            cases = [c for c in cases if c.name[4:].isdigit()]
        report["subsets"][subset] = len(cases)
        all_cases += cases
    report["cases_total"] = len(all_cases)
    if not all_cases:
        report["errors"].append(f"{pdir}: no cases in any subset")
        return report

    # 80/10/10 split preview computed by the port's own splitter
    # (data/core.py::split_cases, round()-based) — not a
    # re-implementation, so the preview is exactly what a run sees.
    tr, dv, te = split_cases(all_cases)
    report["split_preview"] = dict(
        train=len(tr), dev=len(dv), test=len(te)
    )
    if min(len(tr), len(dv), len(te)) == 0:
        report["errors"].append(
            f"{problem}: {len(all_cases)} cases split to "
            f"{len(tr)}/{len(dv)}/{len(te)} — the loaders assert every "
            "split is non-empty; add cases or merge subsets"
        )

    # Byte totals from stat (cheap, full tree).
    for c in all_cases:
        for name in ("u.npy", "v.npy"):
            p = c / name
            if p.exists():
                report["total_bytes"] += p.stat().st_size

    # Deep-check an evenly spaced sample across subsets.
    idx = np.linspace(
        0, len(all_cases) - 1, min(sample, len(all_cases))
    ).astype(int)
    sampled = [all_cases[i] for i in sorted(set(idx.tolist()))]
    for c in sampled:
        _check_case(problem, c, report)
    report["cases_checked"] = len(sampled)

    sample_files = [
        c / n for c in sampled for n in ("u.npy", "v.npy")
        if (c / n).exists()
    ]
    _estimate_cache_build(sample_files, report["total_bytes"], report)

    if len(report["shapes"]) > 1:
        report["warnings"].append(
            f"{problem}: multiple grid shapes {sorted(report['shapes'])} "
            "— batches cannot mix shapes"
        )
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Validate a CFDBench data tree"
    )
    ap.add_argument("data_dir", type=Path)
    ap.add_argument(
        "--problems", default=",".join(PROBLEMS),
        help="comma-separated subset of cavity,tube,dam,cylinder",
    )
    ap.add_argument(
        "--sample", type=int, default=8,
        help="cases to deep-check per problem (arrays + json)",
    )
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    problems = [p.strip() for p in args.problems.split(",") if p.strip()]
    unknown = set(problems) - set(PROBLEMS)
    if unknown:
        ap.error(f"unknown problems {sorted(unknown)}")
    if not args.data_dir.is_dir():
        ap.error(f"{args.data_dir} is not a directory")

    reports = [
        check_problem(args.data_dir, p, args.sample) for p in problems
    ]
    n_errors = sum(len(r["errors"]) for r in reports)

    if args.as_json:
        print(json.dumps(dict(
            data_dir=str(args.data_dir), ok=n_errors == 0,
            problems=reports,
        ), indent=2))
    else:
        for r in reports:
            print(f"== {r['problem']} ==")
            counts = " ".join(
                f"{s}={n}" for s, n in r["subsets"].items()
            ) or "none"
            print(f"  cases: {counts} (total {r['cases_total']}, "
                  f"checked {r.get('cases_checked', 0)})")
            if "split_preview" in r:
                sp = r["split_preview"]
                print(f"  split 80/10/10: train={sp['train']} "
                      f"dev={sp['dev']} test={sp['test']}")
            if r["shapes"]:
                print(f"  grids: {', '.join(r['shapes'])}; "
                      f"frames sampled: {r['frames']}")
            print(f"  size: {r['total_bytes'] / 1e6:.1f} MB", end="")
            if r.get("est_full_read_s_numpy") is not None:
                print(f"; est full read {r['est_full_read_s_numpy']}s "
                      f"(np.load @ {r['read_mb_s_numpy']} MB/s)", end="")
                if r.get("read_mb_s_native"):
                    print(f", {r['est_full_read_s_native']}s "
                          f"(native @ {r['read_mb_s_native']} MB/s)", end="")
            print()
            for w in r["warnings"]:
                print(f"  WARN  {w}")
            for e in r["errors"]:
                print(f"  ERROR {e}")
        print(f"\n{'OK' if n_errors == 0 else 'FAILED'}: "
              f"{n_errors} error(s), "
              f"{sum(len(r['warnings']) for r in reports)} warning(s)")
    return 1 if n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
