"""Dry-run of the port without XLA (counterpart of ``repro.launch.dryrun``):
every (architecture x input shape) cell on the production single-pod
(16, 16) and multi-pod (2, 16, 16) layouts, recording per-card state
bytes, FLOPs, bytes touched and the collective schedule for the roofline
(``repro_torch.launch.roofline``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
        --shape train_4k --multipod both --out build/dryrun/dryrun.json

The JAX package lowers and compiles each cell for 512 placeholder devices
and reads XLA's analyses. Here nothing is compiled and nothing allocated:

  * argument and output bytes per card: the meta-device tree
    (``build_model(cfg, device="meta")``) laid out by ``spec_for`` and
    ``shard_shape``: for train the params, fp32 m and v, the step and the
    batch; for prefill the params and the batch; for decode the params,
    the cache under ``cache_specs`` and the tokens (and the cache_len
    scalar), at the shape's full batch and sequence. ``bytes_by_part``
    lists them;
  * FLOPs per card: ``torch.utils.flop_counter.FlopCounterMode`` over one
    step of rank 0 of the production mesh, on meta tensors, at full depth
    and sequence (the layer loop is Python, so nothing is extrapolated:
    ``depth_points`` stays empty and the ``*_raw`` fields repeat the
    headline ones). On meta tensors a loop over blocks
    (``common.block_of``: ``tok_einsum``'s token blocks, the chunked
    attention's chunks, mamba1's scan, whose only counted product sums
    over the chunks alike) takes the whole in one block, with the blocks'
    operation count; the SSD scan batches its chunks' products anyway;
  * bytes per card: every operation's tensor operands and result once,
    views excluded, unfused (as XLA's CPU "bytes accessed", an upper
    bound);
  * collective bytes per card, by kind: the same step over torch's
    ``fake`` process-group backend, a world of 256 (or 512) with this
    process as rank 0, counted by ``Mesh.counts``: each collective's
    output bytes, the JAX definition;
  * temp and peak bytes: XLA's numbers, with no counterpart short of
    running the cell: None, with ``measured`` False (a card run fills
    ``peak_bytes`` from ``torch.cuda.max_memory_allocated``).

A decode cell is one step at the last position of a full cache (cache_len
= seq - 1); a prefill cell fills a cache of its sequence. ``run_dkpca_cell``
is the paper's own workload, one node per card: its per-node useful FLOPs
by the JAX formula, its bytes and messages per iteration from the ring's
own ledger (``core.dkpca`` over a world-1 gloo group on the CPU: the
per-node ledger does not depend on J or M) and its FLOPs per node per
iteration from ``FlopCounterMode`` over that ring.

Each cell runs in a worker process of a pool as wide as the CPUs this
process may use (or the cells, if fewer). Results are written
incrementally (--resume skips completed cells).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time
import traceback
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import (ARCH_NAMES, SHAPES, applicable, get_config,
                       train_batch_specs)
from ..distributed.sharding import (cache_specs, default_rules, shard_shape,
                                    spec_for)
from ..models import build_model

OUT = "build/dryrun/dryrun.json"
# the kind names of the JAX dry-run's collective schedule
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter"}


def production_layout(multi_pod: bool):
    """(shape, axis names) of ``launch.mesh.make_production_mesh``."""
    return ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))


class StubMesh:
    """A mesh's axis sizes alone: what ``spec_for``, ``shard_shape`` and
    ``cache_specs`` read."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, shape))

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    error: str = ""
    compile_s: float = 0.0
    flops_per_device: float = 0.0
    bytes_accessed_per_device: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None
    alias_bytes: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)
    n_devices: int = 0
    n_params: float = 0.0
    n_active_params: float = 0.0
    # the full-depth step is counted as it runs: the raw fields are the
    # headline ones and depth_points stays empty (nothing extrapolated)
    flops_raw: float = 0.0
    bytes_raw: float = 0.0
    collectives_raw: dict = dataclasses.field(default_factory=dict)
    depth_points: list = dataclasses.field(default_factory=list)
    measured: bool = False          # temp/peak from a card run
    bytes_by_part: dict = dataclasses.field(default_factory=dict)


class SkipCell(Exception):
    pass


def resolve_cfg(arch: str, shape_name: str, attention_impl: str = None):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    if attention_impl:
        cfg = dataclasses.replace(cfg, attention_impl=attention_impl)
    elif shape.kind == "prefill":
        # memory-bounded flash-style attention for long prefill, as the
        # JAX dry-run chooses
        cfg = dataclasses.replace(cfg, attention_impl="chunked")
    return cfg, shape


def rules_for(cfg, multi_pod: bool):
    rules = default_rules(multi_pod)
    rules.update(dict(cfg.sharding_overrides))
    return rules


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _batch_spec(shape, rules, mesh):
    """The JAX dry-run's batch layout: the leading dim over the batch axes
    (replicated where they do not divide it, as its decode tokens)."""
    spec = (rules["batch"],) + (None,) * (len(shape) - 1)
    return spec if shape[0] % mesh.size(rules["batch"]) == 0 \
        else (None,) * len(shape)


def cell_bytes(cfg, shape, mesh, rules, seq: Optional[int] = None):
    """(per-card argument bytes by part, output bytes) of a cell on
    ``mesh`` (anything with the axis sizes: a ``StubMesh``)."""
    model = build_model(cfg, device="meta").with_mesh(mesh, rules)
    params, axes = model.init(None)
    pshard = {k: shard_shape(v.shape, spec_for(v.shape, axes[k], rules,
                                               mesh), mesh)
              for k, v in params.items()}
    parts = {"params": sum(_nbytes(s, params[k].dtype)
                           for k, s in pshard.items())}

    def batch_bytes(specs):
        return sum(_nbytes(shard_shape(v.shape, _batch_spec(
            v.shape, rules, mesh), mesh), v.dtype) for v in specs.values())

    if shape.kind == "train":
        fp32 = sum(_nbytes(s, torch.float32) for s in pshard.values())
        parts.update(m=fp32, v=fp32, step=4,
                     batch=batch_bytes(train_batch_specs(cfg, shape,
                                                         seq=seq)))
        out = parts["params"] + 2 * fp32 + 4 + 4           # state, loss
    elif shape.kind == "prefill":
        parts["batch"] = batch_bytes(train_batch_specs(cfg, shape, seq=seq))
        meta = model._init_cache(cfg, shape.batch, seq or shape.seq,
                                 torch.bfloat16, device="meta")
        cspecs = cache_specs(meta, mesh, rules)
        out = _nbytes((shape.batch, cfg.vocab), torch.bfloat16) + sum(
            _nbytes(shard_shape(t.shape, sp, mesh), t.dtype)
            for t, sp in zip(meta, cspecs))
    else:
        meta = model._init_cache(cfg, shape.batch, shape.seq, torch.bfloat16,
                                 device="meta")
        cspecs = cache_specs(meta, mesh, rules)
        parts["cache"] = sum(_nbytes(shard_shape(t.shape, sp, mesh), t.dtype)
                             for t, sp in zip(meta, cspecs))
        tok = (shape.batch, 1)
        parts["tokens"] = _nbytes(shard_shape(tok, _batch_spec(
            tok, rules, mesh), mesh), torch.int32)
        parts["cache_len"] = 4
        out = _nbytes((shape.batch, cfg.vocab), torch.bfloat16) \
            + parts["cache"]
    return parts, out


class BytesMode(TorchDispatchMode):
    """Counts every operation's tensor operands and result once (views
    and collectives excluded): unfused bytes touched."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        aliased = any(r.alias_info is not None for r in schema.returns)
        if not aliased and func.namespace == "aten":
            seen = set()
            for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += t.numel() * t.element_size()
        return out


def fake_mesh(shape, axes):
    """This process as rank 0 of a world of prod(shape) over torch's
    ``fake`` backend (no peer, no data moved), laid out as a
    ``distributed.Mesh`` on the meta device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from ..distributed.collectives import Mesh
    if dist.is_initialized():
        raise RuntimeError("the dry-run's fake world needs a process with "
                           "no process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return Mesh(init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes),
                torch.device("meta"))


def collectives_of(counts) -> Dict[str, dict]:
    """``Mesh.counts`` in the JAX dry-run's form: {kind: {count, bytes}}."""
    return {KINDS.get(k, k): {"count": counts[k],
                              "bytes": counts.get(k + "_bytes", 0)}
            for k in counts if not k.endswith("_bytes")}


def run_step(model, cfg, shape, mesh):
    """One step of ``shape`` by ``model`` on ``mesh``, its params and
    inputs on the model's device (meta tensors, or zeros for a live
    check): (FLOPs, bytes touched), counting from zero on
    ``mesh.counts``."""
    from ..distributed.sharding import local_shard
    from ..optim import AdamWConfig, adamw_init, global_norm
    from ..optim.adamw import adamw_update_
    from ..train.loop import loss_and_grads, sum_replicated_grads
    sh = model.shards()
    full, _ = model.init(None)
    dev = model.device
    zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=dev)
    params = {k: zeros(local_shard(v, sh.specs[k], mesh).shape, v.dtype)
              for k, v in full.items()}
    batch = {k: zeros(v.shape, v.dtype)
             for k, v in train_batch_specs(cfg, shape).items()}
    if shape.kind == "decode":
        cache = model.init_cache(shape.batch, shape.seq)
        tokens = zeros((shape.batch, 1), torch.int32)
    elif shape.kind == "train":
        state = adamw_init(params)
    mesh.counts.clear()
    fc, bm = FlopCounterMode(display=False), BytesMode()
    with fc, bm:
        if shape.kind == "train":
            total, _, grads = loss_and_grads(model, params, batch)
            sum_replicated_grads(grads, sh)
            gnorm = global_norm(grads, sh.specs, mesh)
            adamw_update_(AdamWConfig(), params, grads, state, gnorm=gnorm)
        elif shape.kind == "prefill":
            model.prefill(params, batch, shape.seq)
        else:
            model.decode_step(params, cache, tokens, shape.seq - 1)
    return float(fc.get_total_flops()), float(bm.bytes)


def measure(cfg, shape, multi_pod: bool, rules=None, mesh_shape=None,
            axes=None):
    """(FLOPs, bytes touched, collectives by kind) per card of one step of
    rank 0 of the production layout (or ``mesh_shape`` over ``axes``)."""
    import torch.distributed as dist
    if mesh_shape is None:
        mesh_shape, axes = production_layout(multi_pod)
    mesh = fake_mesh(mesh_shape, axes)
    try:
        model = build_model(cfg, mesh=mesh, device="meta").with_mesh(
            mesh, rules or rules_for(cfg, "pod" in axes))
        flops, nbytes = run_step(model, cfg, shape, mesh)
        return flops, nbytes, collectives_of(mesh.counts)
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             attention_impl: str = None) -> CellResult:
    mesh_shape, axes = production_layout(multi_pod)
    mesh_name = "x".join(str(n) for n in mesh_shape)
    res = CellResult(arch=arch, shape=shape_name, mesh=mesh_name, ok=False)
    try:
        cfg, shape = resolve_cfg(arch, shape_name, attention_impl)
        rules = rules_for(cfg, multi_pod)
        res.n_devices = math.prod(mesh_shape)
        res.n_params = float(cfg.n_params())
        res.n_active_params = float(cfg.active_params())
        parts, out = cell_bytes(cfg, shape, StubMesh(mesh_shape, axes),
                                rules)
        res.bytes_by_part = parts
        res.argument_bytes = int(sum(parts.values()))
        res.output_bytes = int(out)
        t0 = time.time()
        flops, nbytes, colls = measure(cfg, shape, multi_pod, rules)
        res.compile_s = time.time() - t0
        res.flops_per_device = res.flops_raw = flops
        res.bytes_accessed_per_device = res.bytes_raw = nbytes
        res.collectives = colls
        res.collectives_raw = dict(colls)
        res.ok = True
    except SkipCell as e:
        res.error = f"SKIP: {e}"
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        res.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-2000:]}"
    return res


def dkpca_per_node_flops(n: int, hops: int) -> float:
    """The JAX dry-run's analytic useful FLOPs of one ADMM iteration a
    node: K^-1 B (2 N^2 S), znorm + p (2 S^2 N^2 * 2), the alpha solve
    (6 N^2), the eta update (2 N^2)."""
    s = 2 * hops + 1
    return float(2 * n ** 2 * s + 4 * s ** 2 * n ** 2 + 8 * n ** 2)


def ring_ledger(n_per_node: int, m_dim: int, hops: int, n_iters: int = 2,
                message_dtype=None):
    """(the ring's per-node ``CommLedger``, FLOPs a node an iteration) of
    ``dkpca_distributed`` over a world-1 gloo group on the CPU, at the
    fewest nodes the ring takes (2 * hops + 1): per-node traffic does not
    depend on J, and the FLOPs are the difference of n_iters and
    2 n_iters iterations over the J nodes."""
    import torch.distributed as dist
    from ..core import KernelSpec, dkpca_distributed
    from ..obs.comm import CommLedger
    j = 2 * hops + 1
    x = torch.randn((j, n_per_node, m_dim),
                    generator=torch.Generator().manual_seed(0))
    flops = []
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            for k in (n_iters, 2 * n_iters):
                ledger = CommLedger()
                with FlopCounterMode(display=False) as fc:
                    dkpca_distributed(x, hops=hops,
                                      spec=KernelSpec(kind="rbf", gamma=1e-3),
                                      n_iters=k, gamma=1e-3, ledger=ledger,
                                      message_dtype=message_dtype,
                                      device="cpu")
                flops.append(fc.get_total_flops())
        finally:
            dist.destroy_process_group()
    return ledger, (flops[1] - flops[0]) / (n_iters * j)


def run_dkpca_cell(multi_pod: bool, n_per_node: int = 512, m_dim: int = 784,
                   hops: int = 2, message_dtype=None,
                   tag: str = "") -> CellResult:
    """The paper's own workload on the production layout: one network node
    per card (J = 256 or 512), the ring over ``torch.distributed``. The
    per-iteration traffic is the ring ledger's one node's; useful FLOPs
    the JAX dry-run's formula (kept in n_params / n_active_params as
    there)."""
    mesh_shape, _ = production_layout(multi_pod)
    res = CellResult(arch="dkpca-paper" + tag,
                     shape=f"N{n_per_node}xM{m_dim}",
                     mesh="x".join(str(n) for n in mesh_shape), ok=False)
    try:
        res.n_devices = math.prod(mesh_shape)
        t0 = time.time()
        ledger, flops = ring_ledger(n_per_node, m_dim, hops,
                                    message_dtype=message_dtype)
        res.compile_s = time.time() - t0
        per = ledger.per_iter
        res.flops_per_device = res.flops_raw = float(flops)
        res.collectives = {
            "collective-permute": {"count": per.messages,
                                   "bytes": per.bytes},
            "all-reduce": {"count": per.collectives,
                           "bytes": per.collective_bytes}}
        res.collectives_raw = dict(res.collectives)
        res.argument_bytes = 4 * (n_per_node * m_dim + n_per_node)
        res.n_params = res.n_active_params = dkpca_per_node_flops(
            n_per_node, hops)
        res.ok = True
    except Exception as e:  # noqa: BLE001
        res.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-2000:]}"
    return res


def _write(path: str, results: dict) -> None:
    with open(path, "w") as f:
        json.dump({"|".join(k): v for k, v in results.items()}, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multipod", default="both",
                    choices=["both", "single", "multi"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--attention-impl", default=None)
    ap.add_argument("--dkpca", action="store_true",
                    help="also run the paper's own workload cell")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    if args.arch == "dkpca":
        archs = []
        args.dkpca = True
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    pods = {"both": [False, True], "single": [False],
            "multi": [True]}[args.multipod]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = {tuple(k.split("|")): v for k, v in json.load(f).items()}

    todo = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                key = (arch, shape, "2x16x16" if mp else "16x16")
                if key in results and (results[key].get("ok")
                                       or results[key].get("error", "")
                                       .startswith("SKIP")):
                    continue
                todo.append((key, (arch, shape, mp, args.attention_impl)))

    def done(key, r):
        results[key] = dataclasses.asdict(r)
        status = "ok" if r.ok else r.error.splitlines()[0]
        print(f"[dryrun] {key} -> {status} ({r.compile_s:.1f}s, "
              f"flops/dev={r.flops_per_device:.3g}, "
              f"args={r.argument_bytes / 2 ** 30:.2f}GiB)", flush=True)
        _write(args.out, results)

    if todo:
        import concurrent.futures as cf
        import multiprocessing
        workers = min(len(todo), len(os.sched_getaffinity(0)))
        with cf.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            futs = {pool.submit(run_cell, *a): key for key, a in todo}
            for fut in cf.as_completed(futs):
                done(futs[fut], fut.result())
    if args.dkpca:
        for mp in pods:
            key = ("dkpca-paper", "N512xM784", "2x16x16" if mp else "16x16")
            if not (key in results and results[key].get("ok")):
                print(f"[dryrun] {key} ...", flush=True)
                r = run_dkpca_cell(mp)
                results[key] = dataclasses.asdict(r)
                print(f"[dryrun] {key} -> "
                      f"{'ok' if r.ok else r.error.splitlines()[0]}",
                      flush=True)
                _write(args.out, results)

    n_ok = sum(1 for v in results.values() if v["ok"])
    n_skip = sum(1 for v in results.values()
                 if v.get("error", "").startswith("SKIP"))
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed")
    return 0 if n_ok + n_skip == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
