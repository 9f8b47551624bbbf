#!/usr/bin/env python3
"""Where a full-width training step of the port spends its time, on the
card.

    PYTHONPATH=src python3 scripts/train_step_profile.py
    PYTHONPATH=src python3 scripts/train_step_profile.py --remat none full

Builds llama3.2-3b at its published width and depth (bf16 params, fp32
moments), and for each remat policy asked for runs warm AdamW steps of
4 x 128 tokens from ``TokenStream``: the step's wall time (synchronised at
both ends) and peak allocation, then one step under ``torch.profiler``
(CPU and CUDA): device time, device calls, idle share, the host ops with
the most self CPU time and the device kernels with the most time, and the
same split for the step's three parts (loss and grads, the grad norm and
its guard, the in-place update). Prints one JSON line per policy and the
card's name and power limit. Needs a CUDA card.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def top(events, key, n=12):
    rows = sorted(((getattr(e, key), e.key, e.count) for e in events
                   if getattr(e, key) > 0), reverse=True)[:n]
    return [dict(op=k[:80], calls=c, ms=v / 1e3) for v, k, c in rows]


def profile_part(torch, fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e6
    host = [e for e in ev if e.device_type == DeviceType.CPU]
    return dict(traced_wall_s=wall, device_s=busy,
                device_calls=sum(e.count for e in dev
                                 if e.device_time_total > 0),
                host_ops=sum(e.count for e in host),
                top_host_self=top(host, "self_cpu_time_total"),
                top_device=top(dev, "device_time_total", 8))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--remat", nargs="+", default=["full", "none"])
    ap.add_argument("--steps", type=int, default=3, help="warm steps timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_step_profile: needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.optim.adamw import adamw_update_
    from repro_torch.train import build_train_step
    from repro_torch.train.loop import loss_and_grads
    base = get_config("llama3.2-3b")
    state = None
    for remat in args.remat:
        model = build_model(dataclasses.replace(base, remat=remat),
                            device="cuda")
        opt = AdamWConfig()
        init_fn, step_fn = build_train_step(model, opt)
        if state is None:
            state, _ = init_fn(0)
        data = TokenStream(base.vocab, 4, 128, seed=0, device="cuda")
        batch = data.next_batch()
        step_fn(state, batch)                       # warm
        walls, peaks = [], []
        for _ in range(args.steps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append((torch.cuda.max_memory_allocated() - held) / 1e9)
        wall = sorted(walls)[len(walls) // 2]
        step = profile_part(torch, lambda: step_fn(state, batch))
        step["idle_share"] = 1.0 - step["device_s"] / wall
        parts = {}
        holder = {}

        def grads():
            holder["g"] = loss_and_grads(model, state["params"], batch)[2]

        parts["loss_and_grads"] = profile_part(torch, grads)
        parts["global_norm"] = profile_part(
            torch, lambda: bool(torch.isfinite(global_norm(holder["g"]))))
        parts["adamw_update_"] = profile_part(
            torch, lambda: adamw_update_(opt, state["params"], holder["g"],
                                         state))
        holder.clear()
        print(json.dumps(dict(remat=remat, tokens=4 * 128, wall_s=wall,
                              walls_s=walls, tokens_per_s=512 / wall,
                              peak_above_state_gb=max(peaks), step=step,
                              parts=parts)), flush=True)
        del model
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
