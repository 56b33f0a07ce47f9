"""On a card (``-m cuda``): the control, the program's TF32 path, is not
correct where the program is, for each cell at a small size; and without a
card the benchmark refuses to run."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, variants

ROOT = Path(harness.__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fno-rollout-b128", "unet-rollout-b256"])
def test_control_is_not_correct_where_the_program_is(card, small_cell, name):
    cell = small_cell(name)
    assert harness.run_cell(cell, 7, 0.5, False, card)["correct"]
    assert not harness.run_cell(cell, 7, 0.5, False, card, plant=variants.tf32)["correct"]


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "fno-rollout-b128",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
