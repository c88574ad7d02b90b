"""One short run of each cell on the card (skips without one)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CARD_CELLS = ("ring.bulk", "window.bulk")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CARD_CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


def test_run_without_a_card_prints_no_result():
    import torch


    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ring.bulk", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
