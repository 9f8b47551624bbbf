"""Traced windows of a fit cell (``fit-j80`` by default) with the
program's spans as profiler ranges, and without them, in turns: the
per-layer metrics the benchmark reads, the program spans' record
(``kpcabench/program_spans.py``) and the readings made from it, and the
shares of device and idle seconds the spans claim. One JSON line a run.

    python3 scripts/fit_spans.py --seeds 3000000301,3000000302 \\
        [--spans 0,1] [--cell fit-j80]

Each run is the cell's own traced run (``kpcabench/runners/fit.py``: set-up,
a warm fit, the traced fits, the comparison with the reference); with
``--spans 1`` the program's tracer is on for the traced window (``profiled``
below), so its spans are profiler ranges. The order of the two alternates
from seed to seed. Needs a card; ``--dry-run`` runs the
cell's dry sizes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from kpcabench import common, program_spans, tracing  # noqa: E402
from kpcabench.runners import fit as fit_runner  # noqa: E402

LAYERS = ("setup.", "solver.", "package.")


def profiled(fn, sync):
    """``tracing.profiled`` with the program's tracer on for the window,
    and the program spans' record added to the digest."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs import trace
    sync()
    before = trace.active()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(tracing.WINDOW):
                out = fn()
                sync()
    finally:
        trace.install(before)
    events = prof.events()
    d = tracing.digest(events)
    d.update(program_spans.program(events, program_spans.launches(prof)))
    return out, d


def one(cell, seed: int, spans: bool, device: str) -> dict:
    fit_runner.profiled = profiled if spans else tracing.profiled
    out = fit_runner.run(cell, seed, 0.0, True, device)
    d = out.digest
    ctx = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic,
                          digest=d, counters=out.counters, chips=cell.chips)
    metrics = {m["name"]: common.reader(m["name"])(ctx)
               for m in cell.per_layer}
    metrics.update({k: f(ctx) for k, f in program_spans.READINGS.items()})
    limits = cell.spec["limits"]
    line = dict(seed=seed, spans=int(spans), fits=out.attempted,
                correct=common.verdict(
                    {k: dict(value=v, limit=limits[k])
                     for k, v in out.checks.items()}),
                checks=out.checks, metrics=metrics,
                window_s=d["window_s"], busy_s=d["busy_s"],
                bench_spans=d["spans"],
                breakdown=tracing.breakdown(d))
    if "program" in d:
        fits = out.attempted
        device = sum(r["device_s"] for r in d["program"].values())
        idle = d["window_s"] - d["busy_s"]
        claimed = sum(r["idle_s"] for name, r in d["program"].items()
                      if name.startswith(LAYERS))
        line.update(
            device_claimed_pct=100.0 * device / (device + d["unattributed_s"])
            if device else None,
            idle_claimed_pct=100.0 * claimed / idle if idle else None,
            unattributed_s=d["unattributed_s"],
            unattributed_idle_s=d["unattributed_idle_s"],
            per_fit={name: dict(n=r["n"] / fits,
                                host_ms=1e3 * r["host_s"] / fits,
                                device_ms=1e3 * r["device_s"] / fits,
                                calls=r["calls"] / fits,
                                idle_ms=1e3 * r["idle_s"] / fits)
                     for name, r in sorted(d["program"].items())})
    return line


def card() -> dict:
    import subprocess
    import torch
    if not torch.cuda.is_available():
        return dict(device="cpu")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return dict(device=torch.cuda.get_device_name(0),
                nvidia_smi=smi.stdout.strip(), torch=torch.__version__)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/fit_spans.py")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--spans", default="0,1")
    ap.add_argument("--cell", default="fit-j80")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    import torch
    cell = common.load_cell(args.cell)
    if args.dry_run:
        cell, device = cell.dry(), "cpu"
    elif not torch.cuda.is_available():
        print("fit_spans: no CUDA device", file=sys.stderr)
        return 2
    else:
        device = "cuda"
    modes = [bool(int(m)) for m in args.spans.split(",")]
    print(json.dumps(card()), flush=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for spans in (modes if i % 2 == 0 else modes[::-1]):
            print(json.dumps(one(cell, seed, spans, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
