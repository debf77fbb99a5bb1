"""The control on the card: the plain reference in TF32 put in the program's
place makes the run come out not correct, while the program's own numbers
pass the same limits.  A short window, at the cell's own sizes; run it on
the card with

    PYTHONPATH=src python -m pytest -m cuda kvbench/tests/test_kvbench_control.py
"""

import json

import pytest

from kvbench.tests.helpers import REPO

CELLS = [c["name"] for c in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read on the card")
    from kvbench import run

    out = run.run_cell(cell, 2**31 + 101, 5.0, False, control=True, emit=lambda line: None)
    assert out["correct"] is False, out["checks"]
    assert out["program_correct"] is True, out["checks"]
