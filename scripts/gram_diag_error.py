#!/usr/bin/env python3
"""The gram kernel's error against float64 on a self-Gram's diagonal and
off it, beside the plain fp32 version's, and its time per call, on the
card.

    PYTHONPATH=src python3 scripts/gram_diag_error.py
    python3 scripts/gram_diag_error.py --src /path/to/other/checkout/src

Self-Grams (rbf, median bandwidth): the activation probe's at
llama3.2-3b's width (96 seeded rows of 3072 features at the pooled
embeddings' scale, 0.005), the paper's fit's pooled 2000 x 784
(``node_dataset(20, 100, 784, seed=0)``) and a batch of 20 windows of 500
consecutive rows of it (the setup's shape); and, for time only, a
cross-Gram of 100 of its rows against all 2000 (a path with no
diagonal). Time: CUDA events over 50 calls after
5, host launch included. ``--src`` picks the checkout whose
``repro_torch`` (and kernel sources) are measured, so two trees can be
compared in one call. Prints one JSON line per Gram and the card's name
and power limit. Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def errors(k, exact, eye):
    d = (k.double() - exact).abs()
    return dict(diag=float(d[:, eye].max()), offdiag=float(d[:, ~eye].max()))


def event_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gram_diag_error: needs a CUDA card")
    from repro_torch.core import KernelSpec
    from repro_torch.core.kernels_math import resolve_gamma
    from repro_torch.data import node_dataset
    from repro_torch.kernels import gram_reference, gram_tiles
    dev = torch.device("cuda")
    spec = KernelSpec(kind="rbf")
    probe = torch.randn((96, 3072), device=dev, generator=torch.Generator(
        device=dev).manual_seed(2)) * 0.005
    nodes, _ = node_dataset(20, 100, 784, seed=0)
    fit = torch.as_tensor(nodes, device=dev).reshape(2000, 784)
    slots = fit[(torch.arange(20, device=dev)[:, None] * 100
                 + torch.arange(500, device=dev)[None]) % 2000]
    cases = (("96x96x3072 probe", probe[None], None),
             ("2000x2000x784 fit", fit[None], None),
             ("20x500x500x784 setup", slots, None),
             ("100x2000x784 cross", fit[None, :100], fit[None]))
    for label, x, y in cases:
        x = x.contiguous()
        g = resolve_gamma(spec, x[0])
        got = gram_tiles(spec, x, y, g)
        row = dict(gram=label, src=args.src, ms=event_ms(
            torch, lambda: gram_tiles(spec, x, y, g)))
        if y is None:
            want = gram_reference(spec, x, gamma=g)
            exact = gram_reference(spec, x.double(), gamma=g.double())
            eye = torch.eye(x.shape[1], dtype=torch.bool, device=dev)
            row.update(kernel=errors(got, exact, eye),
                       plain=errors(want, exact, eye))
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
