"""The control on the card at each cell's own size: the float32 reference
in the program's place, computed in fp8, fails the cell's limits, and so
does the half-batch fault of a training cell.  Needs an NVIDIA GPU:

    python -m pytest portbench/tests/test_portbench_control.py -q
"""

import pytest
import torch

from portbench import control
from portbench.harness import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    return torch.device("cuda", 0)


def _fails(readings: dict, limits: dict) -> bool:
    return any(limits[n].get("compared", True) and readings[n] > limits[n]["limit"]
               for n in limits if n in readings)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_the_cells_limits(workload, card):
    cell = spec.load_cell(workload)
    fam = cell.family()
    if cell.traffic["runner"] == "ddib":
        got = control.transfer_control(cell, fam, 2**34 + 1, card)
    else:
        got = control.train_control(cell, fam, 2**34 + 1, card)
        assert _fails(got["half_batch"], cell.limits), got
    assert _fails(got["control"], cell.limits), got
