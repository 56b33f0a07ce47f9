#!/usr/bin/env python
"""Mask-overlay sanity plot (mirror of
``scripts/visualization/plot_mask_overlay.py:10-30``; the port's
counterpart of ``scripts/plot_mask_overlay.py``, on
``cfdbench_tpu_torch``'s case loader): overlays the geometry mask on the
velocity field of one case to verify obstacle placement.

Usage: python scripts/plot_mask_overlay_torch.py <case_dir> <problem> [out.png]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402

from cfdbench_tpu_torch.data.core import load_case  # noqa: E402


def main():
    case_dir = Path(sys.argv[1])
    problem = sys.argv[2]
    out = sys.argv[3] if len(sys.argv) > 3 else "mask_overlay.png"

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    case = load_case(problem, case_dir)
    u = case.features[-1, :, :, 0]
    mask = case.features[0, :, :, 2]
    fig, axs = plt.subplots(1, 3, figsize=(12, 3.5))
    axs[0].imshow(u)
    axs[0].set_title("u (last frame)")
    axs[1].imshow(mask, cmap="gray")
    axs[1].set_title("mask")
    masked = np.ma.masked_where(mask > 0.5, np.ones_like(mask))
    axs[2].imshow(u)
    axs[2].imshow(masked, cmap="autumn", alpha=0.7)
    axs[2].set_title("overlay (masked-out in color)")
    fig.savefig(out, bbox_inches="tight")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
