"""Parametric ICEM mesh generation for the dam/step problem.

Capability mirror of ``generation-code/icem-rpl/mesh.py``: from a
barrier (height, width) grid, compute the geometry points and node
counts that parameterize the ``.rpl`` replay script, and expand a
template with them.

Geometry/meshing rules (mesh.py:1-14):
    point7  = (0,      h)        nodes_x1 = w/0.01 + 1
    point8  = (0.5,    h)        nodes_x2 = (1 - w)/0.01 + 1
    point9  = (0.5+w,  h)        nodes_y1 = (h - 0.1)/0.01 + 1
    point10 = (0.5+w,  0.1)      nodes_y2 = (1 - h)/0.01 + 1
    point11 = (0.5+w,  0)
    point12 = (1.5,    h)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def barrier_grid() -> List[Tuple[float, float]]:
    """The reference's (h, w) sweep: h ∈ linspace(0.11, 0.15, 5) ×
    w ∈ linspace(0.01, 0.1, 10) — 50 geometry cases (mesh.py:19-26)."""
    hs = np.linspace(0.11, 0.15, 5)
    ws = np.linspace(0.01, 0.1, 10)
    return [(float(h), float(w)) for h in hs for w in ws]


def mesh_params(h: float, w: float, spacing: float = 0.01
                ) -> Dict[str, object]:
    return dict(
        point7=(0.0, h, 0.0),
        point8=(0.5, h, 0.0),
        point9=(0.5 + w, h, 0.0),
        point10=(0.5 + w, 0.1, 0.0),
        point11=(0.5 + w, 0.0, 0.0),
        point12=(1.5, h, 0.0),
        nodes_x1=int(round(w / spacing)) + 1,
        nodes_x2=int(round((1 - w) / spacing)) + 1,
        nodes_y1=int(round((h - 0.1) / spacing)) + 1,
        nodes_y2=int(round((1 - h) / spacing)) + 1,
    )


def expand_rpl(template_text: str, h: float, w: float,
               project_name: str) -> str:
    """Substitute ``{key}`` placeholders of a ``.rpl`` template with
    the computed mesh parameters."""
    params = mesh_params(h, w)
    subs: Dict[str, str] = {"project_name": project_name}
    for k, v in params.items():
        if isinstance(v, tuple):
            subs[k] = " ".join(f"{c:g}" for c in v)
        else:
            subs[k] = str(v)
    out = template_text
    for k, v in subs.items():
        out = out.replace("{" + k + "}", v)
    return out
