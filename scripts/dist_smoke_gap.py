#!/usr/bin/env python3
"""Where the fp32 smoke model's params part between one device and a
device mesh after a few AdamW steps, leaf by leaf, and why.

    PYTHONPATH=src python3 scripts/dist_smoke_gap.py [--device cuda|cpu]

The run ``chip_smoke.py --phase lm_train_dist`` gates: the fp32
llama3.2-3b smoke config from seed 0, 3 steps of 4 x 32 tokens (lr 3e-4
after one warm-up step, eps 1e-8), once on one device and once over 4
ranks on each of the (4, 1), (2, 2) and (1, 4) ("data", "model") meshes
(NCCL, one rank a card; ``--device cpu``: gloo processes). Every step's
gradients are recorded as the optimizer receives them (gathered whole on
a mesh). For each mesh it prints one JSON line per leaf, largest first
(the TOP largest): max|dp| / max|p| after the last step (the gate reads
the largest over the leaves), the element where |dp| is largest, that
element's gradient at each step on both sides, its least |g| / eps, and
the same ratio over the elements whose one-device gradient stays above
FLOOR x eps at every step. Adam's update m/(sqrt(v)+eps) is flat in g
where |g| >> eps and steep near eps, so an element whose gradient cancels
to about eps turns a rounding-level change of its gradient into a visible
change of its step. Then a summary line per mesh and the card's name and
power limit (on the card).
"""

import argparse
import json
import multiprocessing
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH, STEPS, BATCH, SEQ, WARMUP, SCHEDULE_STEPS = (
    "llama3.2-3b", 3, 4, 32, 1, 8)
MESHES = ((4, 1), (2, 2), (1, 4))
WORLD = 4
FLOOR, TOP = 100.0, 5


def smoke_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH, smoke=True),
                               param_dtype="float32",
                               compute_dtype="float32")


def run_steps(dev, mesh=None) -> dict:
    """STEPS steps from seed 0: {"grads": [per step {key: whole grad}],
    "params": {key: whole param}}, on the CPU."""
    import torch
    import repro_torch.train.loop as loop
    from repro_torch.data import TokenStream
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    cfg = smoke_cfg()
    model = build_model(cfg, mesh=mesh, device=dev)
    shards = model.shards()
    whole = (lambda k, t: t.detach().cpu().clone()) if shards is None else (
        lambda k, t: gather_full(t.detach(), shards.specs[k],
                                 shards.mesh).cpu())
    seen = []
    update = loop.adamw_update_

    def recording_update(opt_cfg, params, grads, state, gnorm=None):
        seen.append({k: whole(k, g) for k, g in grads.items()})
        return update(opt_cfg, params, grads, state, gnorm=gnorm)

    loop.adamw_update_ = recording_update
    try:
        opt = AdamWConfig(schedule=cosine_with_warmup(WARMUP,
                                                      SCHEDULE_STEPS))
        init_fn, step_fn = loop.build_train_step(model, opt, mesh)
        state, _ = init_fn(0)
        data = TokenStream(cfg.vocab, BATCH, SEQ, seed=0, device=str(dev))
        for _ in range(STEPS):
            step_fn(state, data.next_batch())
    finally:
        loop.adamw_update_ = update
    return dict(grads=seen, params={k: whole(k, v)
                                    for k, v in state["params"].items()})


def rank_main(rank: int, device: str, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch import make_mesh
    meshes = {shape: make_mesh(shape, ("data", "model"), device=device,
                               rank=rank, world_size=WORLD,
                               local_rank=rank if device == "cuda" else 0,
                               init_method=f"file://{store}")
              for shape in MESHES}
    try:
        for shape, mesh in meshes.items():
            res = run_steps(mesh.device, mesh)
            if rank == 0:
                torch.save(res, f"{out}/mesh_{shape[0]}x{shape[1]}.pt")
    finally:
        dist.destroy_process_group()


def leaf_lines(ref: dict, got: dict, eps: float, floor: float) -> list:
    import torch
    lines = []
    for k, p1 in ref["params"].items():
        d = (got["params"][k] - p1).abs()
        scale = max(float(p1.abs().max()), 1e-30)
        g1 = torch.stack([g[k] for g in ref["grads"]])      # (steps, ...)
        gm = torch.stack([g[k] for g in got["grads"]])
        least = g1.abs().amin(dim=0)
        sound = least > floor * eps
        i = int(torch.argmax(d))
        at = lambda t: [float(v) for v in t.reshape(STEPS, -1)[:, i]]
        lines.append(dict(
            leaf=k, ratio=float(d.max()) / scale, max_abs_p=scale,
            element=i, grad_one_device=at(g1), grad_mesh=at(gm),
            least_abs_grad_over_eps=float(least.reshape(-1)[i]) / eps,
            elements=d.numel(),
            elements_below_floor=int((~sound).sum()),
            ratio_above_floor=(float(d[sound].max()) / scale
                               if bool(sound.any()) else 0.0)))
    return sorted(lines, key=lambda r: -r["ratio"])


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        raise SystemExit(f"dist_smoke_gap: needs {WORLD} cards "
                         f"(--device cpu runs gloo processes)")
    from repro_torch.optim import AdamWConfig
    eps = AdamWConfig().eps
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    ref = run_steps(dev)
    ctx = multiprocessing.get_context("spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        procs = [ctx.Process(target=rank_main,
                             args=(r, args.device, f"{tmp}/store", tmp))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
        codes = [p.exitcode for p in procs]
        if codes != [0] * WORLD:
            raise SystemExit(f"dist_smoke_gap: rank exit codes {codes}")
        got = {shape: torch.load(f"{tmp}/mesh_{shape[0]}x{shape[1]}.pt")
               for shape in MESHES}
    for shape in MESHES:
        lines = leaf_lines(ref, got[shape], eps, FLOOR)
        for line in lines[:TOP]:
            print(json.dumps(dict(mesh=list(shape), **line)), flush=True)
        print(json.dumps(dict(
            mesh=list(shape), summary=True,
            worst_ratio=lines[0]["ratio"], worst_leaf=lines[0]["leaf"],
            worst_ratio_above_floor=max(r["ratio_above_floor"]
                                        for r in lines),
            floor_x_eps=FLOOR,
            leaves_over_1e_6=[r["leaf"] for r in lines
                              if r["ratio"] > 1e-6])), flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
