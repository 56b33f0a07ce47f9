"""Synthetic case-tree generator (the port's own copy of
``cfdbench_tpu/data/synthetic.py``; the same seed writes the same tree).

The real CFDBench download is ~13 GB; the reference has no test fixtures
at all (SURVEY.md §4). This module writes tiny but structurally faithful
case trees — ``<root>/<problem>/<subset>/case<k>/{u.npy,v.npy,case.json}``
— so loaders, padding, masks, split logic, training, and rollout are all
testable (and benchable) without the download.

Fields are smooth decaying vortex-like flows: they relax exponentially
toward a steady state so the convergence-truncation path is exercised.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Sequence

import numpy as np


def _smooth_field(rng, T, H, W, decay=0.85, scale=1.0):
    """Sum of a few low-frequency modes relaxing toward a steady state."""
    ys, xs = np.meshgrid(
        np.linspace(0, np.pi, H), np.linspace(0, np.pi, W), indexing="ij"
    )
    steady = np.zeros((H, W))
    transient = np.zeros((H, W))
    for _ in range(3):
        ky, kx = rng.integers(1, 4, size=2)
        phase = rng.uniform(0, np.pi)
        amp = rng.uniform(0.3, 1.0) * scale
        steady += amp * np.sin(ky * ys + phase) * np.cos(kx * xs)
        ky, kx = rng.integers(1, 4, size=2)
        transient += (
            rng.uniform(0.3, 1.0) * scale * np.cos(ky * ys) * np.sin(kx * xs)
        )
    fac = decay ** np.arange(T)
    return steady[None] + fac[:, None, None] * transient[None]


def _case_json(problem: str, rng, grid: int = 64) -> Dict[str, float]:
    base = dict(
        density=float(rng.uniform(1.0, 10.0)),
        viscosity=float(rng.uniform(1e-3, 1e-2)),
        height=float(rng.uniform(0.5, 2.0)),
        width=float(rng.uniform(0.5, 2.0)),
    )
    if problem == "cavity":
        return dict(vel_top=float(rng.uniform(1.0, 50.0)), **base)
    if problem == "tube":
        return dict(vel_in=float(rng.uniform(1.0, 50.0)), **base)
    if problem == "dam":
        # dx/dy scaled to the fixture grid (real data: 64-col grid with
        # dx=0.0234375); barrier must span >= 1 cell to be maskable.
        return dict(
            case_no=0.0,
            velocity=float(rng.uniform(0.01, 0.5)),
            density=base["density"],
            viscosity=base["viscosity"],
            barrier_height=0.1,
            barrier_width=max(0.05, 2 * 1.5 / grid),
            height=0.4,
            width=1.5,
            dx=1.5 / grid,
            dy=0.4 / grid,
        )
    if problem == "cylinder":
        return dict(
            vel_in=float(rng.uniform(1.0, 50.0)),
            density=base["density"],
            viscosity=base["viscosity"],
            x_min=-2.0,
            x_max=2.0,
            y_min=-2.0,
            y_max=2.0,
            center_x=0.0,
            center_y=0.0,
            radius=float(rng.uniform(0.3, 0.6)),
        )
    raise ValueError(problem)


def generate_problem(
    root: Path,
    problem: str,
    subsets: Sequence[str] = ("prop", "bc", "geo"),
    cases_per_subset: int = 4,
    num_frames: int = 12,
    grid: int = 16,
    seed: int = 0,
) -> Path:
    """Write a synthetic case tree for one problem; returns its dir."""
    rng = np.random.default_rng(seed)
    problem_dir = Path(root) / problem
    for subset in subsets:
        for k in range(cases_per_subset):
            case_dir = problem_dir / subset / f"case{k}"
            case_dir.mkdir(parents=True, exist_ok=True)
            u = _smooth_field(rng, num_frames, grid, grid)
            v = _smooth_field(rng, num_frames, grid, grid, scale=0.5)
            np.save(case_dir / "u.npy", u.astype(np.float32))
            np.save(case_dir / "v.npy", v.astype(np.float32))
            params = _case_json(problem, rng, grid=grid)
            with open(case_dir / "case.json", "w") as f:
                json.dump(params, f, indent=2)
    return problem_dir


def generate_all(
    root: Path,
    cases_per_subset: int = 4,
    num_frames: int = 12,
    grid: int = 16,
    seed: int = 0,
) -> Path:
    for i, problem in enumerate(("cavity", "tube", "dam", "cylinder")):
        generate_problem(
            root,
            problem,
            cases_per_subset=cases_per_subset,
            num_frames=num_frames,
            grid=grid,
            seed=seed + i,
        )
    return Path(root)
