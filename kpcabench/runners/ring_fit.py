"""Back-to-back decentralized fits over a ring of processes, one card
each: the paper's "truly parallel" layout, the J nodes split in blocks
over the ranks, exchanging only with their ring neighbours.

This process builds the kernels once, then spawns one rank process a
chip; they meet at a file store inside a temporary directory (under
``TMPDIR``) and form a NCCL group (gloo on the CPU). Each rank draws the
same pool of datasets and alpha0 from the seed on its own card and runs
``core.dkpca.dkpca_distributed`` over the group; rank 0 then packages the
gathered solution with ``core.oos.from_decentralized``, synchronises, and
decides after each fit, by one broadcast, whether the window is over.
Rank 0 times the window after a barrier. The ranks write what they
measured to the temporary directory; this process compares a sample of
rank 0's fits with the reference, on the first card, once every rank has
ended.
"""

from __future__ import annotations

import json
import multiprocessing
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..common import forbidden_modules, sample
from ..tracing import profiled
from . import Outcome
from .fit import compare, fresh, make_inputs, no_phase, sync_of, synced

JOIN_TIMEOUT_S = 900


def ring_program(cfg: dict, group, rank: int):
    from repro_torch.core import (KernelSpec, RhoSchedule,
                                  dkpca_distributed, oos)
    spec = KernelSpec(kind=cfg["kernel"])
    rho2 = RhoSchedule(tuple(cfg["rho2"]["boundaries"]),
                       tuple(float(v) for v in cfg["rho2"]["values"]))

    def fit(x, a0, phase):
        with phase("ring"):
            res = dkpca_distributed(
                x, group=group, hops=cfg["hops"], spec=spec,
                center=cfg["center"], rho1=cfg["rho1"], rho2=rho2,
                n_iters=cfg["iterations"], alpha0=a0, device=x.device)
        if rank != 0:
            return None
        with phase("package"):
            model = oos.from_decentralized(x, res.alpha, spec,
                                           device=x.device)
        return res.alpha, model.row_mean_coef, model.bias
    return fit


def rank_main(rank: int, world: int, store: str, out: str, cell, seed: int,
              seconds: float, trace: bool, dry: bool) -> None:
    """One rank: set-up, warm-up fit, the window, what it measured."""
    import torch.distributed as dist
    from repro_torch.launch import make_process_group
    group, dev = make_process_group("cpu" if dry else "cuda", rank=rank,
                                    world_size=world, local_rank=rank,
                                    init_method=store)
    try:
        cfg, traffic, spec = cell.config, cell.traffic, cell.spec
        sync = sync_of(dev)
        fit = ring_program(cfg, group, rank)
        pool, a0 = make_inputs(cfg, traffic, seed, dev)
        fit(pool[0], a0[0], no_phase)
        sync()
        dist.barrier()
        ready = time.time()
        outputs, digest = {}, None
        if trace:
            phase = synced(sync)

            def window():
                for i in range(1, 1 + spec["trace_fits"]):
                    outputs[i] = fit(pool[i], a0[i], phase)
            _, digest = profiled(window, sync)
            elapsed = digest["window_s"]
        else:
            flag = torch.zeros((1,), dtype=torch.int32, device=dev)
            n = 0
            t0 = time.perf_counter()
            while True:
                i = fresh(n, pool.shape[0])
                outputs[i] = fit(pool[i], a0[i], no_phase)
                sync()
                n += 1
                elapsed = time.perf_counter() - t0
                flag.fill_(int(elapsed >= seconds))
                dist.broadcast(flag, src=0, group=group)
                if int(flag.item()):
                    break
        peak = torch.cuda.max_memory_allocated(dev) if not dry else 0
        Path(out, f"rank{rank}.json").write_text(json.dumps(dict(
            fits=n if not trace else len(outputs), elapsed=elapsed, ready=ready, peak=peak,
            digest=digest, forbidden=forbidden_modules())))
        if rank == 0:
            torch.save({i: tuple(t.cpu() for t in o)
                        for i, o in outputs.items()}, Path(out, "fits.pt"))
    finally:
        dist.destroy_process_group()


RANK_TARGET = rank_main      # what each rank process runs


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    dry = torch.device(device).type == "cpu"
    world = cell.chips
    if not dry:
        from repro_torch.kernels._build import build
        build()                       # once, before the ranks load it
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="kpcabench-ring-") as tmp:
        procs = [ctx.Process(target=RANK_TARGET,
                             args=(r, world, f"file://{tmp}/store", tmp,
                                   cell, seed, seconds, trace, dry))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if hung or any(codes):
            raise RuntimeError(f"ring ranks {hung} hung; exit codes {codes}")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(world)]
        outputs = torch.load(Path(tmp, "fits.pt"))
    bad = sorted({m for r in ranks for m in r["forbidden"]})
    if bad:
        print(f"kpcabench: the ranks loaded {bad}", file=sys.stderr)
        raise SystemExit(3)
    lead = ranks[0]
    setup_end = time.perf_counter() - (time.time() - lead["ready"])
    fits = lead["fits"]
    picks = [sorted(outputs)[k]
             for k in sample(len(outputs), cell.spec["sample"], seed, 1)]
    ref_dev = torch.device("cpu") if dry else torch.device("cuda", 0)
    pool, a0 = make_inputs(cell.config, cell.traffic, seed, ref_dev)
    keep = {i: (pool[i].clone(), a0[i].clone()) for i in picks}
    del pool, a0
    outputs = {i: tuple(t.to(ref_dev) for t in outputs[i]) for i in picks}
    found = compare(cell.config, {i: v[0] for i, v in keep.items()},
                    {i: v[1] for i, v in keep.items()}, outputs, picks)
    digests = [r["digest"] for r in ranks]
    traced = all(d is not None for d in digests)
    return Outcome(
        setup_end=setup_end,
        end_to_end=dict(ring_fit_s=lead["elapsed"] / fits),
        attempted=fits, failed=0, checks=found,
        memory_peak_bytes=max(r["peak"] for r in ranks),
        counters=dict(fits=fits, world=world), digest=digests[0],
        busy_s=sum(d["busy_s"] for d in digests) / world if traced
        else None,
        window_s=digests[0]["window_s"] if traced else None)


__all__ = ["rank_main", "ring_program", "run"]
