"""One short run of each one-card cell on the card: the line's keys, the
device, and ``correct``. Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest

from kpcabench.common import ROOT, load_cell


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["fit-j80", "serve-j20-bulk", "fit-j20",
                                      "train-zamba2-1.2b"])
def test_short_run_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")
    out = subprocess.run(
        [sys.executable, "kpcabench/run.py", "--workload", workload,
         "--seed", "5", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is True
    assert "setup_s" in line["metrics"]
    for m in load_cell(workload).end_to_end:
        assert line["metrics"][m["name"]]["value"] > 0, m["name"]


def test_no_result_without_a_card():
    """Without CUDA (here, or with the card hidden) a run exits non-zero
    and prints no result."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "kpcabench/run.py", "--workload", "fit-j80",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
