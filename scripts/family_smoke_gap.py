#!/usr/bin/env python3
"""Where the families' fp32 smoke params part between the card and the
CPU after a few AdamW steps, leaf by leaf, and why.

    PYTHONPATH=src python3 scripts/family_smoke_gap.py [--device cuda|cpu]

The run ``chip_smoke.py``'s ``lm_families`` gates (its
``smoke_steps_card_vs_cpu``): each of the falcon-mamba-7b, zamba2-1.2b
and seamless-m4t-large-v2 smoke configs in fp32 from the same CPU-drawn
weights, 8 AdamW steps (cosine_with_warmup(1, 8), eps 1e-8) of 4 x 32
tokens (seamless with its frames), on the CPU and on the device. Every
step's gradients are recorded as the optimizer receives them. For each
config it prints one JSON line per leaf for the TOP largest: max|dp| /
max|p| after the last step, whether the leaf was drawn as zeros, the
element where |dp| is largest, that element's gradient at each step on
both sides, its least |g| / eps, and the same ratio over the elements
whose CPU gradient stays above FLOOR x eps at every step. Adam's update
m/(sqrt(v)+eps) is flat in g where |g| >> eps and steep near eps, so an
element whose gradient cancels to about eps turns a rounding-level change
of its gradient into a visible change of its step; a leaf drawn as zeros
holds nothing but those steps. Then a summary line per config and the
card's name and power limit (``--device cpu`` runs both sides on the CPU:
a dry run, every gap 0).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FLOOR, TOP = 100.0, 5


def recorded_runs(name: str, dev) -> tuple:
    """chip_smoke's card-against-CPU smoke run of ``name``, with every
    step's gradients: (runs, {"cpu": [per step {key: grad}], "card": ...})."""
    import repro_torch.train.loop as loop
    from repro_torch.configs import get_config
    import chip_smoke
    seen = []
    update = loop.adamw_update_

    def recording_update(opt_cfg, params, grads, state, gnorm=None):
        seen.append({k: g.detach().cpu().clone() for k, g in grads.items()})
        return update(opt_cfg, params, grads, state, gnorm=gnorm)

    loop.adamw_update_ = recording_update
    try:
        cfg = get_config(name, smoke=True)
        runs = chip_smoke.smoke_steps_card_vs_cpu(chip_smoke.fp32(cfg), dev,
                                                  cfg.enc_seq)
    finally:
        loop.adamw_update_ = update
    steps = chip_smoke.TRAIN_SMOKE_STEPS
    return runs, dict(cpu=seen[:steps], card=seen[steps:])


def leaf_lines(runs, grads, eps: float) -> list:
    import torch
    lines = []
    steps = len(grads["cpu"])
    for k, p1 in runs["cpu"][1].items():
        d = (runs["card"][1][k].cpu() - p1).abs()
        scale = max(float(p1.abs().max()), 1e-30)
        g1 = torch.stack([g[k] for g in grads["cpu"]])
        gc = torch.stack([g[k] for g in grads["card"]])
        least = g1.abs().amin(dim=0)
        sound = least > FLOOR * eps
        i = int(torch.argmax(d))
        at = lambda t: [float(v) for v in t.reshape(steps, -1)[:, i]]
        lines.append(dict(
            leaf=k, drawn_as_zeros=not bool(runs["init"][k].any()),
            ratio=float(d.max()) / scale, max_abs_p=scale, element=i,
            grad_cpu=at(g1), grad_card=at(gc),
            least_abs_grad_over_eps=float(least.reshape(-1)[i]) / eps,
            elements=d.numel(), elements_below_floor=int((~sound).sum()),
            ratio_above_floor=(float(d[sound].max()) / scale
                               if bool(sound.any()) else 0.0)))
    return sorted(lines, key=lambda r: -r["ratio"])


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("family_smoke_gap: needs a CUDA card "
                         "(--device cpu is a dry run)")
    import chip_smoke
    from repro_torch.optim import AdamWConfig
    eps = AdamWConfig().eps
    dev = torch.device(args.device)
    for name in chip_smoke.FAM_FULL:
        runs, grads = recorded_runs(name, dev)
        lines = leaf_lines(runs, grads, eps)
        for line in lines[:TOP]:
            print(json.dumps(dict(config=name, **line)), flush=True)
        drawn = [r for r in lines if not r["drawn_as_zeros"]]
        zeros = [r for r in lines if r["drawn_as_zeros"]]
        print(json.dumps(dict(
            config=name, summary=True,
            worst_drawn=(drawn[0]["ratio"], drawn[0]["leaf"]),
            worst_zeros=((zeros[0]["ratio"], zeros[0]["leaf"]) if zeros
                         else None),
            worst_zeros_least_abs_grad_over_eps=(
                zeros[0]["least_abs_grad_over_eps"] if zeros else None),
            worst_ratio_above_floor=max(r["ratio_above_floor"]
                                        for r in lines),
            floor_x_eps=FLOOR)), flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
