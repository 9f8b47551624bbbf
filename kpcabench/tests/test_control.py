"""The control (the reference in the program's place, its products in
TF32; in a training cell in float8, the probe's in TF32) has to come out
as not correct by the cells' own numbers and limits;
here at the tiny sizes a test run holds, on three seeds. On the card it
runs at the cells' sizes (``python3 kpcabench/control.py``)."""

import pytest

from kpcabench import common, control

SEEDS = (1, 2, 2 ** 31 + 3)


@pytest.mark.parametrize("workload", ["fit-j80", "serve-j80-bulk",
                                      "serve-j20-bulk", "fit-j20",
                                      "train-zamba2-1.2b"])
def test_control_fails_a_number(workload):
    cell = common.load_cell(workload).dry()
    limits = cell.spec["limits"]
    for seed in SEEDS:
        got = control.readings(cell, seed, 4, "cpu")
        assert any(got[k] > limits[k] for k in limits), (seed, got)


def test_training_faults_planted_in_the_reference():
    """The reference put in the program's place with a fault: a step that
    returns its state unchanged reads 1 on ``grad`` and ``update``; half
    of the batch left out moves the loss."""
    cell = common.load_cell("train-zamba2-1.2b").dry()
    frozen = control.readings(cell, 5, 1, "cpu", "unchanged")
    assert frozen["grad"] == 1.0 and frozen["update"] == 1.0
    half = control.readings(cell, 5, 1, "cpu", "half_batch")
    assert half["loss"] > cell.spec["limits"]["loss"]
