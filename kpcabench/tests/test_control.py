"""The control (the reference in the program's place, its products in
TF32) has to come out as not correct by the cells' own numbers and limits;
here at the tiny sizes a test run holds, on three seeds. On the card it
runs at the cells' sizes (``python3 kpcabench/control.py``)."""

import pytest

from kpcabench import common, control

SEEDS = (1, 2, 2 ** 31 + 3)


@pytest.mark.parametrize("workload", ["fit-j80", "serve-j80-bulk",
                                      "serve-j20-bulk"])
def test_control_fails_a_number(workload):
    cell = common.load_cell(workload).dry()
    limits = cell.spec["limits"]
    for seed in SEEDS:
        got = control.readings(cell, seed, 4, "cpu")
        assert any(got[k] > limits[k] for k in limits), (seed, got)
