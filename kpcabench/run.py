"""One run of one benchmark cell:

    python3 kpcabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--dry-run]

from the root of a checkout. It loads the cell's files by the names in
``BENCHMARK.json``, makes its inputs from the seed on the card, warms up
every shape the cell uses (set-up, timed into ``setup_s``), measures for
``--seconds`` seconds (``--trace 1``: a shorter window under the
profiler, which gives the per-layer metrics instead of the end-to-end
ones), compares what the timed path produced with the plain reference,
and prints one JSON line last on standard output.

It exits non-zero and prints no result where torch sees no CUDA device or
fewer than the cell's chips, or where a JAX module is loaded once the
window has closed. ``--dry-run`` runs the cell's control flow on the CPU
at the tiny sizes its files give under ``dry_run``: the port's plain
PyTorch path, no device metric, a line marked ``"dry_run": true``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()      # set-up is timed from here: imports count

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with one thread of host compute: the cells' loops are
# bound by the host's launches, and pool threads of OpenMP and BLAS would
# only compete with that loop for the machine's cores. Set before numpy
# and torch are imported, so that their pools are made at this size.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from kpcabench import common  # noqa: E402
from kpcabench.runners import kind  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="kpcabench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry-run", action="store_true")
    return ap.parse_args(argv)


def power_limit():
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def per_layer(cell, out):
    """{metric: {"value", "unit"}} of every per-layer metric of the cell
    whose reader found something to read."""
    from types import SimpleNamespace
    ctx = SimpleNamespace(cell=cell, config=cell.config,
                          traffic=cell.traffic, digest=out.digest,
                          counters=out.counters, chips=cell.chips)
    metrics = {}
    for m in cell.per_layer:
        value = common.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    return metrics


def main(argv=None) -> int:
    args = parse(argv)
    cell = common.load_cell(args.workload)
    import torch
    if args.dry_run:
        cell, device = cell.dry(), "cpu"
    else:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"kpcabench: {args.workload} needs {cell.chips} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    # The tile table is read from this variable alone: runs use the
    # program's own tile choices, never a table left in the environment.
    os.environ.pop("REPRO_TILE_TABLE", None)
    t_imports = time.perf_counter() - T0
    out = kind(cell.traffic["kind"]).run(cell, args.seed, args.seconds,
                                         bool(args.trace), device)
    out.counters.setdefault("setup_stages", {})["imports_s"] = t_imports
    bad = common.forbidden_modules()
    if bad:
        print(f"kpcabench: JAX modules are loaded: {bad}", file=sys.stderr)
        return 3
    limits = cell.spec["limits"]
    checks = {k: dict(value=v, limit=limits[k]) for k, v in out.checks.items()}
    correct = common.verdict(checks) and out.failed == 0
    result = dict(correct=correct, attempted=out.attempted, failed=out.failed,
                  counters=out.counters)
    if args.dry_run:
        result.update(metrics={}, dry_run=True,
                      device=dict(platform="cpu", kind="cpu", count=1,
                                  memory_peak_bytes=0))
    else:
        if args.trace:
            metrics = per_layer(cell, out)
        else:
            e2e = dict(out.end_to_end, setup_s=out.setup_end - T0)
            metrics = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                       for m in cell.end_to_end}
        result["metrics"] = metrics
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                   count=cell.chips, memory_peak_bytes=out.memory_peak_bytes,
                   power_limit_w=power_limit())
        if args.trace:
            from kpcabench.tracing import breakdown
            dev.update(busy_s=out.busy_s, window_s=out.window_s)
            result["breakdown"] = breakdown(out.digest)
        result["device"] = dev
    result["checks"] = checks
    common.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
