#!/usr/bin/env python3
"""Where zamba2-1.2b's bf16 step-1 gradient over a four-rank mesh parts
from one device's, leaf by leaf, against the fp32 gradient.

    python3 scripts/ssm_grad_gap.py TREE [TREE ...]
    python3 scripts/ssm_grad_gap.py --meshes 1x4 --exact-bf16 TREE
    python3 scripts/ssm_grad_gap.py --device cpu --seeds 0,1,2 \\
        --over '{"d_model": 256, "d_inner": 512}' --card-gemms TREE

Each TREE is the root of a checkout of the repository (unpack another
commit with `git archive` under `build/`, or a variant of this one).
For each TREE, mesh and seed, four ranks (one a card, NCCL; ``--device
cpu`` gloo) with that checkout's `src` on their path take one
``loss_and_grads`` of zamba2-1.2b (``--smoke``: its smoke config; ``--over``:
a JSON dict of config fields replaced, such as a narrower width) from
the seed's weights on lm_train's first batch (4 x ``--seq`` tokens) over
the mesh, in bf16; rank 0 then takes it alone, in bf16 and with the
weights widened to fp32. ``--exact-bf16`` turns off cuBLAS's
reduced-precision bf16 reductions (``allow_bf16_reduced_precision_
reduction``) in every process. ``--card-gemms`` computes every bf16
product of the model modules from its inputs widened to fp32, rounded
once (a CPU stand-in for a card's bf16 GEMM with fp32 accumulation; the
CPU's own bf16 products round differently). Prints one JSON line each:
the loss and grad norms, their relative gaps, and for every leaf (and
the whole) the norm of the fp32 gradient and the distances of the
one-device and mesh bf16 gradients from it.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

WORLD, BATCH, SEQ = 4, 4, 128

CHILD = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.distributed import local_shard
from repro_torch.distributed.collectives import gather_full
from repro_torch.launch import make_mesh
from repro_torch.models import (attention, build_model, common, encdec,
                                hybrid, lm, mamba, mlp)
from repro_torch.train.loop import loss_and_grads, sum_replicated_grads

rank, store, dev = int(sys.argv[1]), sys.argv[2], sys.argv[3]
shape, smoke, exact = tuple(json.loads(sys.argv[4])), sys.argv[5] == "1", \
    sys.argv[6] == "1"
batch_rows, seq, seed = int(sys.argv[7]), int(sys.argv[8]), int(sys.argv[9])
over, card_gemms = json.loads(sys.argv[10]), sys.argv[11] == "1"
cuda = dev == "cuda"
if cuda and exact:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
if not cuda:
    torch.set_num_threads(1)
if card_gemms:
    def widened(eq, x, w, orig=common.tok_einsum):
        if x.dtype != torch.bfloat16:
            return orig(eq, x, w)
        return orig(eq, x.float(), w.float()).to(torch.bfloat16)
    for m in (attention, encdec, hybrid, lm, mamba, mlp):
        if hasattr(m, "tok_einsum"):
            m.tok_einsum = widened
mesh = make_mesh(shape, ("data", "model"), device=dev, rank=rank,
                 world_size=4, local_rank=rank if cuda else 0,
                 init_method=f"file://{store}")
try:
    cfg = dataclasses.replace(get_config("zamba2-1.2b", smoke=smoke),
                              **over)
    model = build_model(cfg, mesh=mesh, device=mesh.device)
    w, _ = build_model(cfg, device=mesh.device).init(seed)
    batch = TokenStream(cfg.vocab, batch_rows, seq, seed=seed,
                        device=str(mesh.device)).next_batch()
    sh = model.shards()
    _, met, g = loss_and_grads(model, {k: local_shard(
        v, sh.specs[k], mesh).clone() for k, v in w.items()}, batch)
    sum_replicated_grads(g, sh)
    g = {k: gather_full(v, sh.specs[k], mesh).float() for k, v in g.items()}
    if rank == 0:
        _, m16, g16 = loss_and_grads(build_model(cfg, device=mesh.device),
                                     w, batch)
        c32 = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
        _, m32, g32 = loss_and_grads(build_model(c32, device=mesh.device),
                                     {k: v.float() for k, v in w.items()},
                                     batch)
        sq = lambda t: float(t.double().pow(2).sum())
        leaves = {k: dict(fp32=sq(g32[k]) ** .5,
                          one_bf16=sq(g16[k].float() - g32[k]) ** .5,
                          mesh_bf16=sq(g[k] - g32[k]) ** .5) for k in g32}
        total = lambda f: sum(sq(v) for v in f.values()) ** .5
        n32, n16, nm = total(g32), total({k: v.float()
                                          for k, v in g16.items()}), total(g)
        print(json.dumps(dict(
            loss=dict(fp32=float(m32["loss"]), one_bf16=float(m16["loss"]),
                      mesh_bf16=float(met["loss"])),
            grad_norm=dict(fp32=n32, one_bf16=n16, mesh_bf16=nm),
            one_bf16_from_fp32=(n16 - n32) / n32,
            mesh_from_one_bf16=(nm - n16) / n16,
            leaves=leaves)), flush=True)
finally:
    dist.destroy_process_group()
"""


def run(tree: str, shape, seed: int, args) -> dict:
    src = str(Path(tree).resolve() / "src")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c", CHILD, str(r), f"{tmp}/store",
             args.device, json.dumps(shape), "1" if args.smoke else "0",
             "1" if args.exact_bf16 else "0", str(BATCH), str(args.seq),
             str(seed), args.over, "1" if args.card_gemms else "0"],
            env=dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        logs = [p.communicate(timeout=1200) for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{tree} {shape}: {[e[-2000:] for _, e in logs]}")
    return json.loads(logs[0][0].strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--meshes", default="1x4,2x2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--exact-bf16", action="store_true")
    ap.add_argument("--card-gemms", action="store_true")
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--over", default="{}",
                    help="config fields replaced, as a JSON dict")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (a CPU dry run)")
    args = ap.parse_args(argv)
    for tree in args.trees:
        for m in args.meshes.split(","):
            shape = [int(d) for d in m.split("x")]
            for seed in map(int, args.seeds.split(",")):
                print(json.dumps(dict(
                    tree=tree, mesh=m, seed=seed, exact_bf16=args.exact_bf16,
                    card_gemms=args.card_gemms,
                    **run(tree, shape, seed, args))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
