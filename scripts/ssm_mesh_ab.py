#!/usr/bin/env python3
"""Train the ssm and hybrid families over a four-rank mesh in several
checkouts, in turns: step times and collectives a step.

    python3 scripts/ssm_mesh_ab.py PARENT CHANGE CHANGE PARENT
    python3 scripts/ssm_mesh_ab.py --runs zamba2-1.2b@2x2 TREE
    python3 scripts/ssm_mesh_ab.py --smoke --device cpu TREE TREE

Each TREE is the root of a checkout of the repository (unpack another
commit with `git archive` under `build/`). Every TREE argument, in the
order given, starts WORLD ranks (one process a card, NCCL; with
``--device cpu`` gloo) with that checkout's `src` on their path. Each
rank trains every run of RUNS (falcon-mamba-7b at full width and depth
on (1, 4), zamba2-1.2b on (2, 2) and (1, 4), or those ``--runs`` names)
from seed 0 with lm_train's optimizer and batches (AdamW,
cosine_with_warmup(1, 6), 4 x 128 tokens) for STEPS steps, each timed on
the host clock between two device synchronizations, with the
collectives it issued (``Mesh.counts``: calls and output bytes by kind),
its loss and grad norm, and the card's peak allocation. Prints one JSON
line per tree: rank 0's records and each run's median warm step (steps 2
on).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

WORLD, STEPS, BATCH, SEQ = 4, 4, 4, 128
RUNS = (("falcon-mamba-7b", (1, 4)), ("zamba2-1.2b", (2, 2)),
        ("zamba2-1.2b", (1, 4)))
TIMEOUT_S = 900

CHILD = r"""
import dataclasses, json, statistics, sys, time
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.launch import make_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, cosine_with_warmup
from repro_torch.train import build_train_step

rank, world, store, dev = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
smoke, steps, batch, seq = sys.argv[5] == "1", *map(int, sys.argv[6:9])
runs = json.loads(sys.argv[9])
cuda = dev == "cuda"
sync = torch.cuda.synchronize if cuda else (lambda: None)
meshes, out = {}, {}
try:
    for arch, shape in runs:
        shape = tuple(shape)
        if shape not in meshes:
            meshes[shape] = make_mesh(
                shape, ("data", "model"), device=dev, rank=rank,
                world_size=world, local_rank=rank if cuda else 0,
                init_method=f"file://{store}")
        mesh = meshes[shape]
        cfg = get_config(arch, smoke=smoke)
        if cuda:
            sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        model = build_model(cfg, mesh=mesh, device=mesh.device)
        init_fn, step_fn = build_train_step(
            model, AdamWConfig(schedule=cosine_with_warmup(1, 6)), mesh)
        state, _ = init_fn(0)
        data = TokenStream(cfg.vocab, batch, seq, seed=0,
                           device=str(mesh.device))
        recs = []
        for _ in range(steps):
            b = data.next_batch()
            before = dict(mesh.counts)
            sync()
            t0 = time.perf_counter()
            _, met = step_fn(state, b)
            loss = float(met["loss"])
            sync()
            recs.append(dict(s=time.perf_counter() - t0, loss=loss,
                             grad_norm=float(met["grad_norm"]),
                             collectives={k: v - before.get(k, 0)
                                          for k, v in mesh.counts.items()}))
        out[f"{arch} {list(shape)}"] = dict(
            warm_median_s=statistics.median(r["s"] for r in recs[1:]),
            steps=recs, peak_alloc_gb=(torch.cuda.max_memory_allocated()
                                       - base) / 1e9 if cuda else None)
        del state, model, init_fn, step_fn
        if cuda:
            torch.cuda.empty_cache()
    if rank == 0:
        print(json.dumps(out), flush=True)
finally:
    dist.destroy_process_group()
"""


def run_tree(tree: str, args, runs) -> dict:
    """Every run on WORLD ranks with ``tree``'s `src`: rank 0's records."""
    src = str(Path(tree).resolve() / "src")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c", CHILD, str(r), str(WORLD),
             f"{tmp}/store", args.device, "1" if args.smoke else "0",
             str(args.steps), str(BATCH), str(args.seq), json.dumps(runs)],
            env=dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * WORLD:
        raise RuntimeError(f"{tree}: exit codes {codes}: "
                           f"{[e[-2000:] for _, e in logs]}")
    return json.loads(logs[0][0].strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", default=None,
                    help="comma-separated arch@DxM of RUNS (default all)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs (a CPU dry run)")
    args = ap.parse_args(argv)
    runs = [(a, s) for a, s in RUNS if args.runs is None
            or f"{a}@{s[0]}x{s[1]}" in args.runs.split(",")]
    for tree in args.trees:
        print(json.dumps(dict(tree=tree, runs=run_tree(tree, args, runs))),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
