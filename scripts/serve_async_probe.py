#!/usr/bin/env python3
"""Where the started engine's host time goes on the card: chip_smoke.py's
sustained stream (4096 requests of 1-256 rows) through ``KpcaEngine``
under variants of the client and engine settings, each timed once, then
run once more with the span tracer on (``repro_torch.obs.trace``): the
summed seconds of every span, per thread.

    PYTHONPATH=src python3 scripts/serve_async_probe.py [--variants a,b]

Needs a CUDA device; prints one JSON line per variant.
"""

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# name -> (engine config overrides, client threads, client retry sleep s,
#          interpreter switch interval s or None)
VARIANTS = {
    "retry_100us": ({}, 4, 1e-4, None),
    "base": ({}, 4, 1e-3, None),
    "no_admission": ({"queue_factor": None}, 4, 1e-3, None),
    "one_client": ({}, 1, 1e-3, None),
    "switch_100us": ({}, 4, 1e-3, 1e-4),
    "depth_4": ({"pipeline_depth": 4}, 4, 1e-3, None),
    "bf16": ({"query_dtype": "bf16"}, 4, 1e-3, None),
}


def span_totals(tracer) -> dict:
    names = dict(tracer._thread_names)
    out = collections.defaultdict(float)
    for ph, name, _t0, dur, tid, _attrs in tracer.events():
        if ph == "X":
            thread = names.get(tid, str(tid)).split("_")[0]
            if thread.startswith("Thread-"):
                thread = "client"
            out[f"{thread}:{name}"] += dur / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--requests", type=int, default=4096)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_async_probe: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core import KernelSpec, oos
    from repro_torch.data import node_dataset
    from repro_torch.obs import trace
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    dev = torch.device("cuda")
    _, pooled = node_dataset(20, 100, m=784, seed=0)
    model = oos.fit_central(pooled, KernelSpec(kind="rbf"), device=dev)
    requests = chip_smoke.stream_requests(args.requests)
    rows = sum(x.shape[0] for x in requests)
    base = dict(max_batch=128, min_bucket=8, admission="reject",
                queue_factor=chip_smoke.ASYNC_QUEUE_FACTOR)
    sync = KpcaEngine(model, KpcaServeConfig(max_batch=128, min_bucket=8),
                      device=dev)
    chip_smoke.drain_stream(sync, requests, chip_smoke.STREAM_PER_DRAIN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chip_smoke.drain_stream(sync, requests, chip_smoke.STREAM_PER_DRAIN)
    wall = time.perf_counter() - t0
    print(json.dumps({"variant": "sync", "queries_per_s": rows / wall}),
          flush=True)
    for name in args.variants.split(","):
        cfg, clients, retry, switch = VARIANTS[name]
        if cfg.get("query_dtype") == "bf16":
            cfg = dict(cfg, query_dtype=torch.bfloat16)
        old_switch = sys.getswitchinterval()
        if switch is not None:
            sys.setswitchinterval(switch)
        try:
            with KpcaEngine(model, KpcaServeConfig(**{**base, **cfg}),
                            device=dev) as eng:
                chip_smoke.run_async(eng, requests, clients, retry_s=retry)
                run = chip_smoke.run_async(eng, requests, clients,
                                           retry_s=retry)
                tracer = trace.enable()
                traced = chip_smoke.run_async(eng, requests, clients,
                                              retry_s=retry)
                trace.disable()
        finally:
            sys.setswitchinterval(old_switch)
        print(json.dumps({
            "variant": name, "queries_per_s": rows / run["wall"],
            "traced_queries_per_s": rows / traced["wall"],
            "refused": run["refused"], "stats": run["stats"],
            "latency_ms_p50": run["latency_ms_p50"],
            "queue_wait_ms_p50": run["queue_wait_ms_p50"],
            "span_s": span_totals(tracer)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
