#!/usr/bin/env python3
"""The ring fit's time on the card for one or more source trees, in turns.

    python3 scripts/ring_fit_cost.py [--world W] [--device cpu] TREE ...

Each TREE is a checkout of the repo (a directory holding ``src/``); each
is run in a process of its own, with that tree's ``src`` on the path, in
the order given (give them as A B B A to see drift). A run is
``chip_smoke.py``'s ring fit: ``dkpca_distributed`` over ``RingComm`` on
20 nodes of N = 100, M = 784 (``node_dataset(20, 100, seed=0)``), hops 2,
RBF at the median bandwidth, global centring, 30 iterations, init
"local"; on W NCCL ranks, one card each (W = 1: all 20 nodes on one
card). It prints one JSON line per tree: the first run's seconds, WARM
warm runs' seconds (rank 0's wall, after a barrier), their median, and a
traced warm run's device seconds, device calls (kernel launches and
copies) and idle share; then the card's name and power limit. Needs W
CUDA cards (``--device cpu``: W gloo processes, no device numbers).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WARM = 5


def fit_args():
    from repro_torch.core import KernelSpec
    from repro_torch.data import node_dataset
    nodes, _ = node_dataset(20, 100, m=784, seed=0)
    return nodes, dict(hops=2, spec=KernelSpec(kind="rbf"), center="global",
                       n_iters=30)


def traced(sync, fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in ev) / 1e6
    return dict(device_s=busy, device_calls=sum(e.count for e in ev),
                idle_share=1.0 - busy / wall if ev else None)


def rank_main(rank: int, world: int, store: str, out: str,
              device: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.core import dkpca_distributed
    from repro_torch.launch import make_process_group
    group, dev = make_process_group(device, rank=rank, world_size=world,
                                    local_rank=rank,
                                    init_method=f"file://{store}")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        nodes, kw = fit_args()

        def fit():
            return dkpca_distributed(nodes, group=group, device=dev, **kw)

        times = []
        for _ in range(1 + WARM):
            dist.barrier()
            t0 = time.perf_counter()
            fit()
            sync()
            times.append(time.perf_counter() - t0)
        dist.barrier()
        trace = traced(sync, fit)
        if rank == 0:
            Path(out).write_text(json.dumps(dict(
                world=world, first_s=times[0], warm_s=times[1:],
                warm_median_s=statistics.median(times[1:]), **trace)))
    finally:
        dist.destroy_process_group()


def child(world: int, out: str, device: str) -> None:
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        if world == 1:
            rank_main(0, 1, f"{tmp}/store", out, device)
        else:
            mp.spawn(rank_main, args=(world, f"{tmp}/store", out, device),
                     nprocs=world, join=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args()
    if args.child:
        child(args.world, args.child, args.device)
        return 0
    for tree in args.trees:
        src = str(Path(tree).resolve() / "src")
        env = dict(os.environ, PYTHONPATH=src)
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            proc = subprocess.run(
                [sys.executable, __file__, "--world", str(args.world),
                 "--device", args.device, "--child", f.name], env=env,
                cwd=tree, timeout=600)
            if proc.returncode:
                print(f"ring_fit_cost: {tree}: exit {proc.returncode}",
                      file=sys.stderr)
                return 1
            rec = json.loads(Path(f.name).read_text())
        print(json.dumps(dict(tree=tree, **rec)), flush=True)
    if args.device == "cpu":
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
