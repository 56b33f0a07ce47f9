"""Fluent scheme-journal generation.

Capability mirror of ``generation-code/fluent-scheme/create_scheme.py``:
expand a ``.scm`` template with per-case substitutions (``{mesh}``,
``{density}``, ``{viscosity}``, ``{velocity}``, ``{old_var}``,
``{path_file}``, ``{new_var}``, ``{num_time_steps}``, ``{save_path}``,
``{case_name}``, ``{data_name}``), and build the per-problem parameter
sweeps the reference documents in comments
(``create_scheme.py:31-141``). The sweeps double as the ground truth
for realistic synthetic-parameter generation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np

TEMPLATE_KEYS = [
    "mesh", "density", "viscosity", "velocity", "old_var", "path_file",
    "new_var", "num_time_steps", "save_path", "case_name", "data_name",
]


def expand_template(template_text: str, substitutions: Dict[str, object]
                    ) -> str:
    """Replace ``{key}`` placeholders line by line (unknown keys left
    intact, like the reference's selective replacement)."""
    out_lines = []
    for line in template_text.splitlines():
        for key, value in substitutions.items():
            line = line.replace("{" + key + "}", str(value))
        out_lines.append(line.strip())
    return "\n".join(out_lines) + "\n"


def write_case_journals(
    template_file: Path,
    dst_file: Path,
    cases: Iterable[Dict[str, object]],
) -> int:
    """Append one expanded journal per case dict to ``dst_file``."""
    template = Path(template_file).read_text(encoding="utf8")
    n = 0
    with open(dst_file, "a", encoding="utf8") as f:
        for subs in cases:
            f.write(expand_template(template, subs))
            n += 1
    return n


# --- Documented per-problem parameter sweeps -------------------------

def cavity_sweep() -> Dict[str, np.ndarray]:
    """velocity 1..50 (50 bc cases); density {1..10, 0.1, 0.5} ×
    viscosity {1e-5..1e-2} (84 prop cases) — create_scheme.py:57-80."""
    std_rho, std_mu, std_u = 1.0, 1e-5, 10.0
    u = np.hstack([np.linspace(1, 50, 50), np.full(84, std_u)])
    rho1 = np.append(np.linspace(1, 10, 10), [0.1, 0.5])
    mu1 = np.array([1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2])
    density = np.full(50, std_rho)
    viscosity = np.full(50, std_mu)
    for r in rho1:
        density = np.hstack([density, np.full(7, r)])
        viscosity = np.hstack([viscosity, mu1])
    return dict(velocity=u, density=density, viscosity=viscosity)


def laminar_sweep() -> Dict[str, np.ndarray]:
    """Tube: velocity 0.1..5 (50 bc); density 10..1000 × viscosity
    0.01..1 (100 prop) — create_scheme.py:31-53."""
    std_rho, std_mu, std_u = 100.0, 0.1, 1.0
    u = np.hstack([np.linspace(0.1, 5, 50), np.full(100, std_u)])
    rho1 = np.linspace(10, 1000, 10)
    mu1 = np.linspace(0.01, 1, 10)
    density = np.full(50, std_rho)
    viscosity = np.full(50, std_mu)
    for r in rho1:
        density = np.hstack([density, np.full(10, r)])
        viscosity = np.hstack([viscosity, mu1])
    return dict(velocity=u, density=density, viscosity=viscosity)


def step_sweep() -> Dict[str, np.ndarray]:
    """Dam/step: velocity 0.05..2 (70 bc); density × viscosity grid
    (100 prop) — create_scheme.py:115-133."""
    std_rho, std_mu, std_u = 100.0, 0.1, 1.0
    u = np.hstack([
        np.linspace(0.05, 1.0, 20),
        np.linspace(1.02, 2.0, 50),
        np.full(100, std_u),
    ])
    rho1 = np.linspace(10, 1000, 10)
    mu1 = np.linspace(0.01, 1, 10)
    density = np.full(70, std_rho)
    viscosity = np.full(70, std_mu)
    for r in rho1:
        density = np.hstack([density, np.full(10, r)])
        viscosity = np.hstack([viscosity, mu1])
    return dict(velocity=u, density=density, viscosity=viscosity)


SWEEPS = {
    "cavity": cavity_sweep,
    "tube": laminar_sweep,
    "laminar": laminar_sweep,
    "dam": step_sweep,
    "step": step_sweep,
}


def build_cases(
    problem: str,
    mesh_pattern: str,
    save_root: str,
    num_time_steps: int = 1000,
    start: int = 0,
    count: int = None,
) -> List[Dict[str, object]]:
    """Materialize the substitution dict for each case of a sweep."""
    sweep = SWEEPS[problem]()
    n = count if count is not None else len(sweep["velocity"])
    cases = []
    for i in range(start, start + n):
        cases.append(
            dict(
                mesh=mesh_pattern.format(case=i),
                density=sweep["density"][i % len(sweep["density"])],
                viscosity=sweep["viscosity"][i % len(sweep["viscosity"])],
                velocity=sweep["velocity"][i % len(sweep["velocity"])],
                old_var=f"export-{max(i - 1, 0)}",
                new_var=f"export-{i}",
                path_file=f"{save_root}/case{i}/data{i}.txt",
                num_time_steps=num_time_steps,
                save_path=f"{save_root}/case{i}",
                case_name=f"case{i}.cas.h5",
                data_name=f"case{i}.dat.h5",
            )
        )
    return cases
