#!/usr/bin/env python3
"""Time the port's no-mesh decode step in several checkouts, in turns.

    python3 scripts/decode_step_ab.py PARENT CHANGE CHANGE PARENT
    python3 scripts/decode_step_ab.py --archs llama3.2-3b P C C P P C
    python3 scripts/decode_step_ab.py --smoke --device cpu TREE TREE

Each TREE is the root of a checkout of the repository (unpack another
commit with `git archive` under `build/`). Every TREE argument, in the
order given, runs in a process of its own with that checkout's `src` on
its path: llama3.2-3b at full width and depth, mixtral-8x22b and
deepseek-v2-236b at full width cut to 2 layers (lm_serve's configs, or
those ``--archs`` names), each
from seed 0, a prefill of 4 x 16 tokens into a 64-slot cache, 3 warm
decode steps, then STEPS greedy decode steps timed on the host clock
after a device synchronization. Prints one JSON line per process: the
tree, each config's median and all step times in ms.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

STEPS, BATCH, PROMPT, MAX_LEN = 20, 4, 16, 64
CONFIGS = (("llama3.2-3b", None), ("mixtral-8x22b", 2),
           ("deepseek-v2-236b", 2))

CHILD = r"""
import dataclasses, json, statistics, sys, time
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.models import build_model

smoke, dev, steps, batch, prompt, max_len = (sys.argv[1] == "1",
    torch.device(sys.argv[2]), *map(int, sys.argv[3:7]))
configs = json.loads(sys.argv[7])
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
out = {}
with torch.no_grad():
    for arch, layers in configs:
        cfg = get_config(arch, smoke=smoke)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = build_model(cfg, device=dev)
        params, _ = model.init(0)
        rng = np.random.default_rng(0)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(
            batch, prompt), dtype=np.int32), device=dev)
        logits, cache = model.prefill(params, {"tokens": toks}, max_len)
        times = []
        for i in range(3 + steps):
            tok = torch.argmax(logits.float(), -1)[:, None].to(torch.int32)
            sync()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok, prompt + i)
            sync()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        out[arch] = dict(median_ms=statistics.median(times), ms=times)
        del params, cache, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--archs", default=None,
                    help="comma-separated configs of CONFIGS (default all)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs (a CPU dry run)")
    args = ap.parse_args(argv)
    configs = CONFIGS if args.archs is None else tuple(
        c for c in CONFIGS if c[0] in args.archs.split(","))
    for tree in args.trees:
        src = str(Path(tree).resolve() / "src")
        res = subprocess.run(
            [sys.executable, "-c", CHILD, "1" if args.smoke else "0",
             args.device, str(STEPS), str(BATCH), str(PROMPT), str(MAX_LEN),
             json.dumps(configs)],
            env=dict(os.environ, PYTHONPATH=src), capture_output=True,
            text=True, timeout=600)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps(dict(tree=tree, **json.loads(
            res.stdout.strip().splitlines()[-1]))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
