"""The check's control on the card, at the cell's own size in a short
window: the reference computed in float8 (e4m3 operands, the precision
below the bf16 the configurations state) in the served rows' place must
come out not correct, and a sound run correct. Run on the card:

    python3 -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""

import pytest
import torch

from benchmark import run
from benchmark.harness import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = run.run_cell(cell, 5000000001, 6.0, False, control="fp8",
                       log=lambda s: None)
    assert out["failed"] == 0
    assert out["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = run.run_cell(cell, 5000000002, 6.0, False, log=lambda s: None)
    assert out["correct"] is True, out["check"]
