#!/usr/bin/env python
"""Locate the cylinder obstacle from the data itself (mirror of
``scripts/analysis/locate_cylinder.py:10-25``; the port's counterpart of
``scripts/locate_cylinder.py``, on ``cfdbench_tpu_torch``'s case loader):
find grid cells whose velocity stays ~0 across all frames and compare
against the analytic mask from case.json.

Usage: python scripts/locate_cylinder_torch.py <case_dir>
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402

from cfdbench_tpu_torch.data.core import load_case  # noqa: E402


def main():
    case_dir = Path(sys.argv[1])
    case = load_case("cylinder", case_dir)
    u = case.features[..., 0]
    v = case.features[..., 1]
    speed = np.sqrt(u**2 + v**2)
    zero_cells = (speed.max(axis=0) < 1e-8)  # (H, W)
    mask = case.features[0, :, :, 2] == 0  # analytic obstacle+boundary

    inferred = np.argwhere(zero_cells)
    if inferred.size:
        cy, cx = inferred.mean(axis=0)
        print(f"data-inferred obstacle centroid (row, col): "
              f"({cy:.2f}, {cx:.2f})")
    print(f"analytic center: ({case.params['center_x']}, "
          f"{case.params['center_y']}), radius {case.params['radius']}")
    agree = (zero_cells & mask).sum()
    print(f"zero-velocity cells: {zero_cells.sum()}, "
          f"analytic masked cells: {mask.sum()}, overlap: {agree}")


if __name__ == "__main__":
    main()
