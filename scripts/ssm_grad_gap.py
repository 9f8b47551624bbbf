#!/usr/bin/env python3
"""Where zamba2-1.2b's bf16 step-1 gradient over a four-rank mesh parts
from one device's, leaf by leaf, against the fp32 gradient, and whether
it meets the rule a bf16 mesh step is held to.

    python3 scripts/ssm_grad_gap.py TREE [TREE ...]
    python3 scripts/ssm_grad_gap.py --meshes 1x4 --exact-bf16 TREE
    python3 scripts/ssm_grad_gap.py --device cpu --seeds 0,1,2 --card-gemms \\
        --jax --over '{"d_model": 256, "d_inner": 512, "n_heads": 4,
                       "n_kv_heads": 4, "d_ff": 1024, "vocab": 4096}' TREE

Each TREE is the root of a checkout of the repository (unpack another
commit with `git archive` under `build/`, or a variant of this one).
For each TREE, mesh and seed, four ranks (one a card, NCCL; ``--device
cpu`` gloo) with that checkout's `src` on their path take one
``loss_and_grads`` of zamba2-1.2b (``--smoke``: its smoke config; ``--over``:
a JSON dict of config fields replaced, such as a narrower width) from
the seed's weights on the seed's first batch (4 x ``--seq`` tokens) over
the mesh, in bf16; rank 0 then takes it alone, in bf16 and with the
weights widened to fp32. ``--exact-bf16`` turns off cuBLAS's
reduced-precision bf16 reductions (``allow_bf16_reduced_precision_
reduction``) in every process. ``--card-gemms`` computes every bf16
product of the model modules from its inputs widened to fp32, rounded
once (a CPU stand-in for a card's bf16 GEMM with fp32 accumulation; the
CPU's own bf16 products round otherwise). ``--jax`` (CPU only: the JAX
package, the TREE's `src/repro`, on 4 host devices in one process) also
takes the JAX package's gradients of the same weights and batches: one
device in bf16 and fp32, and its GSPMD step on each mesh in bf16.

Prints one JSON line per package, mesh and seed: the loss and grad norms,
their relative gaps, for every leaf (and "whole", the flattened
gradient) the norm of the fp32 gradient ``fp32``, the distances of the
one-device and mesh bf16 gradients from it (``one_bf16`` = d1,
``mesh_bf16`` = dm) and ``r`` = dm / d1, and ``rule_misses``: the leaves
past the rule ``dm <= 1.25 d1 + 1e-3 |g32|``.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

WORLD, BATCH, SEQ = 4, 4, 128
RULE_FACTOR, RULE_FLOOR = 1.25, 1e-3

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
        print(json.dumps(dict(
            loss=dict(fp32=float(m32["loss"]), one_bf16=float(m16["loss"]),
                      mesh_bf16=float(met["loss"])),
            sums={k: dict(fp32=sq(g32[k]), one_bf16=sq(g16[k].float()),
                          mesh_bf16=sq(g[k]),
                          d1=sq(g16[k].float() - g32[k]),
                          dm=sq(g[k] - g32[k])) for k in g32})), flush=True)
finally:
    dist.destroy_process_group()
"""

# the JAX package's side: every mesh and seed in one process with 4 host
# devices, on the port's seeded weights and batches (drawn here with the
# port, as the ranks draw them)
JAX_CHILD = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config as jget
from repro.distributed.sharding import default_rules, spec_for
from repro.models import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.models import build_model

meshes, smoke, seq = json.loads(sys.argv[1]), sys.argv[2] == "1", \
    int(sys.argv[3])
seeds, over, batch_rows = json.loads(sys.argv[4]), json.loads(sys.argv[5]), \
    int(sys.argv[6])
cfg = dataclasses.replace(get_config("zamba2-1.2b", smoke=smoke), **over)
jcfg = dataclasses.replace(jget("zamba2-1.2b", smoke=smoke), **over)
runs = {}


def run(dt, mesh):
    # one jitted value_and_grad a dtype and mesh, reused for every seed;
    # the logical axes of the leaves, for their placement on a mesh
    key = (dt, None if mesh is None else mesh.devices.shape)
    if key not in runs:
        model = jbuild(dataclasses.replace(jcfg, param_dtype=dt,
                                           compute_dtype=dt), mesh=mesh)
        axes = model.init(jax.random.PRNGKey(0))[1]
        runs[key] = (model, axes, jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b), has_aux=True)))
    return runs[key]


def grads(w, b, dt, mesh=None):
    model, axes, fn = run(dt, mesh)
    params = {k: jnp.asarray(v).astype(dt) for k, v in w.items()}
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    if mesh is not None:
        params = {k: jax.device_put(v, NamedSharding(mesh, spec_for(
            v.shape, axes[k], default_rules(False), mesh)))
            for k, v in params.items()}
        batch = {k: jax.device_put(v, NamedSharding(mesh, P("data", None)))
                 for k, v in batch.items()}
    (_, met), g = fn(params, batch)
    return float(met["loss"]), {k: np.asarray(v.astype(jnp.float32),
                                              np.float64)
                                for k, v in g.items()}


sq = lambda a: float(np.sum(np.square(a)))
for seed in seeds:
    w, _ = build_model(cfg, device="cpu").init(seed)
    w = {k: v.float().numpy() for k, v in w.items()}
    b = TokenStream(cfg.vocab, batch_rows, seq, seed=seed,
                    device="cpu").next_numpy()
    l32, g32 = grads(w, b, "float32")
    l16, g16 = grads(w, b, "bfloat16")
    for m in meshes:
        shape = tuple(int(d) for d in m.split("x"))
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                    ("data", "model"))
        lm_, gm = grads(w, b, "bfloat16", mesh)
        print(json.dumps(dict(mesh=m, seed=seed, out=dict(
            loss=dict(fp32=l32, one_bf16=l16, mesh_bf16=lm_),
            sums={k: dict(fp32=sq(g32[k]), one_bf16=sq(g16[k]),
                          mesh_bf16=sq(gm[k]), d1=sq(g16[k] - g32[k]),
                          dm=sq(gm[k] - g32[k])) for k in g32}))),
              flush=True)
"""


def summary(out: dict) -> dict:
    """The JSON line's body from a child's sums of squares: losses, grad
    norms and their gaps, each leaf's (and the whole's) norms, distances,
    r, and the leaves past the rule."""
    sums = dict(out["sums"])
    sums["whole"] = {f: sum(s[f] for s in out["sums"].values())
                     for f in ("fp32", "one_bf16", "mesh_bf16", "d1", "dm")}
    leaves, misses = {}, []
    for k, s in sums.items():
        n32, d1, dm = (math.sqrt(s[f]) for f in ("fp32", "d1", "dm"))
        leaves[k] = dict(fp32=n32, one_bf16=d1, mesh_bf16=dm,
                         r=dm / d1 if d1 > 0 else None)
        if not dm <= RULE_FACTOR * d1 + RULE_FLOOR * n32:
            misses.append(k)
    n32, n16, nm = (math.sqrt(sums["whole"][f])
                    for f in ("fp32", "one_bf16", "mesh_bf16"))
    return dict(loss=out["loss"],
                grad_norm=dict(fp32=n32, one_bf16=n16, mesh_bf16=nm),
                one_bf16_from_fp32=(n16 - n32) / n32,
                mesh_from_one_bf16=(nm - n16) / n16,
                leaves=leaves, rule_misses=misses)


def _env(tree: str, **over) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(Path(tree).resolve() / "src"),
               OMP_NUM_THREADS="1")
    env.update(over)
    return env


def run(tree: str, shape, seed: int, args) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c", CHILD, str(r), f"{tmp}/store",
             args.device, json.dumps(shape), "1" if args.smoke else "0",
             "1" if args.exact_bf16 else "0", str(BATCH), str(args.seq),
             str(seed), args.over, "1" if args.card_gemms else "0"],
            env=_env(tree), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
            for r in range(WORLD)]
        logs = [p.communicate(timeout=1200) for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{tree} {shape}: {[e[-2000:] for _, e in logs]}")
    return summary(json.loads(logs[0][0].strip().splitlines()[-1]))


def run_jax(tree: str, meshes, seeds, args):
    """The JAX package's lines, one per mesh and seed."""
    proc = subprocess.run(
        [sys.executable, "-c", JAX_CHILD, json.dumps(meshes),
         "1" if args.smoke else "0", str(args.seq), json.dumps(seeds),
         args.over, str(BATCH)],
        env=_env(tree, OMP_NUM_THREADS="4", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=4")),
        capture_output=True, text=True, timeout=3600)
    if proc.returncode:
        raise RuntimeError(f"{tree} jax: {proc.stderr[-3000:]}")
    for line in proc.stdout.strip().splitlines():
        got = json.loads(line)
        yield got["mesh"], got["seed"], summary(got["out"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--meshes", default="1x4,2x2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--exact-bf16", action="store_true")
    ap.add_argument("--card-gemms", action="store_true")
    ap.add_argument("--jax", action="store_true",
                    help="the JAX package's gradients too (CPU only)")
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--over", default="{}",
                    help="config fields replaced, as a JSON dict")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (a CPU dry run)")
    args = ap.parse_args(argv)
    if args.jax and args.device != "cpu":
        ap.error("--jax runs on the CPU only (--device cpu)")
    meshes = args.meshes.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    head = lambda tree, m, seed, pkg: dict(
        tree=tree, package=pkg, mesh=m, seed=seed,
        exact_bf16=args.exact_bf16, card_gemms=args.card_gemms)
    for tree in args.trees:
        for m in meshes:
            shape = [int(d) for d in m.split("x")]
            for seed in seeds:
                print(json.dumps(dict(head(tree, m, seed, "port"),
                                      **run(tree, shape, seed, args))),
                      flush=True)
        if args.jax:
            for m, seed, got in run_jax(tree, meshes, seeds, args):
                print(json.dumps(dict(head(tree, m, seed, "jax"), **got)),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
