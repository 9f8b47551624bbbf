"""The control of ``correct``: the plain reference put in the program's
place and computed one precision lower than the configuration states
(``reference.TF32``: float32 with every product's inputs rounded to TF32,
the step a faster path would be tempted to take), judged by the very
numbers a run compares. It has to come out as not correct.

    python3 kpcabench/control.py --workload <cell> --seeds 1,2,3 [--count k]
        [--fault <name>] [--dry-run]

prints, per seed, the control's worst numbers over ``count`` fits or
requests of the cell's own inputs and sizes (a runner with a ``control``
of its own, as ``runners/train.py``, gives its cells' readings), and the
cell's limits. Runs of the benchmark do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from kpcabench import checks, data, reference  # noqa: E402
from kpcabench.common import load_cell  # noqa: E402
from kpcabench.runners import kind  # noqa: E402


def fit_readings(cell, seed: int, count: int, device) -> dict:
    """The control's fits of the first ``count`` datasets of the seed's
    pool against the reference's."""
    from kpcabench.runners.fit import make_inputs
    traffic = dict(cell.traffic, pool=count + 1)
    pool, a0 = make_inputs(cell.config, traffic, seed, device)
    readings = []
    for i in range(1, count + 1):
        ref = reference.fit(pool[i], a0[i], cell.config, reference.EXACT)
        ctl = reference.fit(pool[i], a0[i], cell.config, reference.TF32)
        readings.append(checks.fit_numbers(ctl.alpha, ctl.row_mean_coef,
                                           ctl.bias, ref))
    return checks.worst(readings)


def score_readings(cell, seed: int, count: int, device) -> dict:
    """The control's scores of ``count`` of the seed's requests against
    the reference's."""
    from kpcabench.runners.serve import requests
    cfg, traffic = cell.config, cell.traffic
    gen = data.generator(seed, device)
    support, coefs, qpool = data.serve_inputs(
        gen, cfg["nodes"] * cfg["samples_per_node"], traffic["pool_rows"],
        cfg["features"], cfg["data"], device)
    ref = reference.served_model(support, coefs, reference.EXACT)
    ctl = reference.served_model(support, coefs, reference.TF32)
    readings = []
    for off, q in requests(traffic, seed)[:count]:
        want, size = reference.scores(ref, qpool[off:off + q])
        got, _ = reference.scores(ctl, qpool[off:off + q], reference.TF32)
        readings.append(checks.score_numbers(got, want, size))
    return checks.worst(readings)


def readings(cell, seed: int, count: int, device, fault: str = "") -> dict:
    runner = kind(cell.traffic["kind"])
    if hasattr(runner, "control"):
        return runner.control(cell, seed, count, device, fault)
    if fault:
        raise SystemExit(f"kpcabench: no fault {fault!r} for this cell")
    if cell.traffic["kind"] in ("fit", "ring_fit"):
        return fit_readings(cell, seed, count, device)
    return score_readings(cell, seed, count, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kpcabench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--count", type=int, default=8)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--fault", default="",
                    help="a fault planted in the reference put in the "
                         "program's place instead of the control (a "
                         "runner's own, e.g. half_batch for training)")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    device = "cpu"
    if args.dry_run:
        cell = cell.dry()
    elif not torch.cuda.is_available():
        print("kpcabench control: no CUDA device", file=sys.stderr)
        return 2
    else:
        device = "cuda"
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(cell, seed, args.count, device, args.fault)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              fault=args.fault, control=got, limits=cell.spec["limits"],
                              fails={k: v > cell.spec["limits"][k]
                                     for k, v in got.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
