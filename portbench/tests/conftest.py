import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import dataclasses
import json

import pytest


@pytest.fixture
def small_cell():
    """A cell of BENCHMARK.json at a size that a test run holds: the same
    code paths, limits and readers, on a small grid at narrow widths. The
    U-Net keeps a 32x32 grid: on 16x16 its bottleneck is one cell a
    sample."""
    from portbench import harness

    def make(name: str):
        cell = harness.find_cell(harness.load_manifest(), name)
        config, mix = json.loads(json.dumps(cell.config)), dict(cell.mix)
        if config["model"] == "fno":
            config["grid"] = [16, 16]
            config["args"].update(fno_hidden_dim=8, fno_modes_x=4, fno_modes_y=4)
        else:
            config["grid"] = [32, 32]
            config["args"].update(unet_dim=4)
        mix.update(batch=4, steps=3, checked=2, checked_among=4)
        return dataclasses.replace(cell, config=config, mix=mix)

    return make
